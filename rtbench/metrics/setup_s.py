"""From process start to the first timed call (host clock): imports, the
CUDA context, the libraries, the scene, the commit, the ray pool and the
warm-up calls."""


def read(run):
    return run.setup_s
