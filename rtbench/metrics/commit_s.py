"""Host-clock seconds of ``Scene.commit(device=...)`` and a synchronize, in
set-up."""


def read(run):
    return run.commit_s
