"""The benchmark's parts: its imports, the frozen generators against the
originals, the least-bytes count, the references and the trace reader."""
import ast
import glob
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from rtbench import harness, least_bytes, trace
from rtbench.reference import flat_bspline, triangle
from rtbench.scenes import triangle_sphere

FORBIDDEN = {"jax", "jaxlib", "flax", "embree_tpu"}


def imported(path):
    """Top-level names of every module a file imports (absolute ones)."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            out.add(n.module.split(".")[0])
    return out


def sources(*sub):
    return sorted(glob.glob(os.path.join(harness.HERE, *sub, "*.py")))


@pytest.mark.parametrize("path", sources() + sources("*"),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_imported(path):
    """Compared whole: embree_tpu_torch begins with embree_tpu."""
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "torch", "contextlib"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import rtbench.reference.triangle, "
            "rtbench.reference.flat_bspline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'embree_tpu_torch', 'embree_tpu', 'jax'}))" % harness.ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "[]"


def test_sphere_generator_is_the_ports():
    """The frozen copy equals the port's createTriangleSphere, and has
    verify.cpp's triangle counts (4 numPhi (numPhi - 1))."""
    from embree_tpu_torch.tools.parity_models import prim_sphere
    for n in (6, 17, 51):
        a = triangle_sphere.triangle_sphere((0, 0, 0), 1.0, n)
        b = prim_sphere("triangle", (0, 0, 0), 1.0, n)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[1].shape == (4 * n * (n - 1), 3)


def test_uniform_box_rays():
    """Each coordinate of origin and direction uniform over its range, the
    batch made by the port's make_rays (t from 0 to inf)."""
    import embree_tpu_torch as pt
    from rtbench import traffic
    from rtbench.rays import uniform_box
    spec = {"count": 200000, "org_lo": -1.0, "org_hi": 1.0, "dir_lo": -0.5,
            "dir_hi": 1.5}
    r = uniform_box.make(spec, traffic.generator(4, 0, "cpu"), "cpu", pt)
    assert uniform_box.count(spec) == 200000 and r.shape == (200000,)
    for x, lo, hi in ((r.org, -1.0, 1.0), (r.dir, -0.5, 1.5)):
        assert x.dtype == torch.float32
        assert float(x.min()) >= lo and float(x.max()) < hi
        assert torch.allclose(x.mean(0), torch.full((3,), (lo + hi) / 2),
                              atol=0.01)
        assert torch.allclose(x.std(0), torch.full((3,), (hi - lo) / 12**.5),
                              atol=0.01)
    assert float(r.tnear.abs().max()) == 0 and bool(torch.isinf(r.tfar).all())


def test_least_bytes_by_hand():
    import embree_tpu_torch as pt
    n = 5
    rays = pt.make_rays(torch.zeros(n, 3), torch.ones(n, 3), device="cpu")
    hit = pt.core.ray.make_miss_hits((n,), device="cpu")
    arrays = {"kind": "triangle", "vertices": np.zeros((7, 3), np.float32),
              "indices": np.zeros((4, 3), np.int32)}
    # rays: org, dir 12 B each; tnear, tfar, time 4 B; mask 8 B
    # hits: t, u, v 4 B; ng 12 B; prim_id, geom_id 8 B; inst_id 16 B
    # buffers: 7 x 12 B of vertices, 4 x 12 B of indices
    assert least_bytes.query_bytes(rays, hit, arrays) == (
        n * (12 + 12 + 4 + 4 + 4 + 8) + n * (4 + 4 + 4 + 12 + 8 + 8 + 16)
        + 7 * 12 + 4 * 12)
    mask = torch.zeros(n, dtype=torch.bool)
    assert least_bytes.query_bytes(rays, mask, arrays) == (
        n * 44 + n + 7 * 12 + 4 * 12)


def test_triangle_reference_by_hand():
    arrays = {"vertices": np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                   np.float32),
              "indices": np.array([[0, 1, 2]], np.int32)}
    prep = triangle.prepare(arrays, "cpu")
    org = torch.tensor([[0.25, 0.5, 1.0], [0.8, 0.8, 1.0], [0.2, 0.2, -1.0]])
    d = torch.tensor([[0.0, 0.0, -2.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    tn, tf = torch.zeros(3), torch.full((3,), float("inf"))
    r = triangle.closest(prep, org, d, tn, tf, torch.float64)
    assert r["valid"].tolist() == [True, False, False]
    assert r["t"][0] == 0.5 and r["u"][0] == 0.25 and r["v"][0] == 0.5
    assert r["ng"][0].tolist() == [0.0, 0.0, 1.0]
    assert r["prim"].tolist() == [0, -1, -1]
    assert triangle.any_hit(prep, org, d, tn, tf, torch.float64).tolist() \
        == [True, False, False]


def strands(n, cps=11, step=0.04, r0=0.004, r1=0.002):
    """Flat B-spline hair on the unit sphere: n strands of ``cps`` control
    points along random normals, radius r0 -> r1; a curve per window of
    four points."""
    nrm = np.random.default_rng(n).standard_normal((n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    k = np.arange(cps)
    pts = nrm[:, None] * (1.0 + step * k)[None, :, None]
    rad = np.broadcast_to(r0 + (r1 - r0) * k / (cps - 1), (n, cps))
    verts = np.concatenate([pts, rad[..., None]], -1).reshape(-1, 4)
    idx = ((cps * np.arange(n))[:, None] + np.arange(cps - 3)[None])
    return {"kind": "flat_bspline", "vertices": verts.astype(np.float32),
            "indices": idx.reshape(-1).astype(np.int32), "rate": 4}


def test_references_agree_with_the_ports_brute_force():
    """On scenes small enough for the port's O(R*T) intersect_brute, with
    rays aimed through the hair's shell."""
    import embree_tpu_torch as pt
    g = torch.Generator().manual_seed(9)

    def unit(n):
        v = torch.randn((n, 3), generator=g)
        return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    org = 2.5 * unit(512)
    rays = pt.make_rays(org, 1.2 * unit(512) - org, device="cpu")
    sphere = triangle_sphere.generate(
        {"num_phi": 7, "radius": 1.0, "center": [0.0, 0.0, 0.0]}, 9)
    hair = strands(256)
    hair_scene = pt.Scene()
    hair_scene.attach(pt.CurveGeometry(hair["vertices"], hair["indices"],
                                       basis="bspline", kind="flat",
                                       tessellation_rate=hair["rate"]))
    for arrays, ref, scene in (
            (sphere, triangle, triangle_sphere.attach(pt, sphere)),
            (hair, flat_bspline, hair_scene)):
        cs = scene.commit(device="cpu")
        hb = pt.intersect_brute(cs, rays)
        r = ref.closest(ref.prepare(arrays, "cpu"), rays.org, rays.dir,
                        rays.tnear, rays.tfar, torch.float64)
        assert torch.equal(hb.valid, r["valid"])
        m = r["valid"]
        assert int(m.sum()) >= 5
        assert torch.equal(hb.prim_id[m], r["prim"][m])
        assert torch.allclose(hb.t[m].double(), r["t"][m], rtol=1e-5)
        assert torch.allclose(hb.u[m].double(), r["u"][m], atol=1e-4)
        assert torch.allclose(hb.v[m].double(), r["v"][m], atol=1e-4)


def test_copies_keep_every_call_across_chunks(monkeypatch):
    """Each call's sampled answers come back in order, also past the rows
    of the first chunk."""
    from rtbench.answers import mask
    monkeypatch.setattr(harness.Copies, "ROWS", 2)
    idx = [torch.tensor([0, 2]), torch.tensor([1, 3])]
    outs = [torch.arange(4) % (k + 2) == 0 for k in range(5)]
    c = harness.Copies(mask, idx, outs[0])
    for k, out in enumerate(outs):
        c.take(out, k % 2)
    assert len(c.chunks) == 3
    got = list(c.taken())
    assert [b for b, _ in got] == [0, 1, 0, 1, 0]
    for k, (b, a) in enumerate(got):
        assert torch.equal(a["mask"], outs[k][idx[b]])


def events(device, host, window):
    return trace.Trace(device=device, host=host, window=window)


def test_trace_union_idle_and_labels():
    tr = events(
        device=[("void trav::persistent_kernel<1>", 10, 40),
                ("void at::native::index_kernel", 30, 50),
                ("Memcpy DtoD (Device -> Device)", 70, 80)],
        host=[("rtbench.window", 0, 100), ("rtbench.call", 5, 60),
              ("aten::sort", 50, 58), ("rtbench.sync", 60, 90),
              ("cudaDeviceSynchronize", 61, 89)],
        window=(0, 100))
    assert trace.busy_intervals(tr) == [(10, 50), (70, 80)]
    assert trace.busy_s(tr) == 50e-9
    assert trace.idle_gaps(tr) == [(0, 10), (50, 70), (80, 100)]
    assert trace.host_at(tr, [5, 54, 65, 95]) == [
        "rtbench.call", "rtbench.call / aten::sort",
        "rtbench.sync / cudaDeviceSynchronize", "rtbench.loop / "
        "rtbench.window"]
    assert trace.device_s(tr, torch_ops=True) == 30e-9
    assert trace.device_s(tr, torch_ops=False) == 30e-9
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["void trav::persistent_kernel<1>", 30e-9]
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(50e-9)


class FakeEvent:
    """The parts of a profiler event that ``trace.from_profiler`` reads."""

    def __init__(self, name, on, a, b, corr=0, tid=1):
        self._v = (name, on, a, b, corr, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return False


def test_trace_leaves_out_the_harness_copies():
    """A device op launched inside ``rtbench.sample`` is not the query's:
    it is left out and its time reads as idle."""
    ev = [FakeEvent("rtbench.window", "CPU", 0, 100),
          FakeEvent("rtbench.call", "CPU", 1, 20),
          FakeEvent("cudaLaunchKernel", "CPU", 2, 3, corr=7),
          FakeEvent("rtbench.sample", "CPU", 40, 50),
          FakeEvent("cudaLaunchKernel", "CPU", 41, 42, corr=8),
          FakeEvent("void trav::persistent_kernel<1>", "CUDA", 5, 30,
                    corr=7, tid=9),
          FakeEvent("void at::native::index_select_kernel", "CUDA", 43, 45,
                    corr=8, tid=9)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    tr = trace.from_profiler(prof)
    assert [d[0] for d in tr.device] == ["void trav::persistent_kernel<1>"]
    assert trace.busy_s(tr) == 25e-9
    assert "rtbench.sample" in [h[0] for h in tr.host]


@pytest.mark.parametrize("name,torch_op", [
    ("void at::native::vectorized_elementwise_kernel<4>", True),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>", True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<>", True),
    ("Memset (Device)", True),
    ("void trav::persistent_kernel<false, true>(trav::Params)", False),
    ("void my_new_kernel(float*)", False)])
def test_name_families(name, torch_op):
    assert trace.is_torch_op(name) is torch_op


def test_metric_readers():
    import importlib
    tr = events([("void trav::k", 0, 2_000_000), ("void at::native::x",
                                                  2_000_000, 3_000_000)],
                [("rtbench.window", 0, 4_000_000)], (0, 4_000_000))
    run = harness.Reading(setup_s=12.0, commit_s=3.0, calls=2,
                          rays_per_call=1000, window_s=0.5,
                          call_s=[0.1] * 19 + [0.3], least_bytes=6_700_000,
                          device_kind="NVIDIA H100 80GB HBM3", trace=tr)
    read = {m: importlib.import_module(f"rtbench.metrics.{m}").read(run)
            for m in ("setup_s", "rays_per_s", "call_ms_p95", "commit_s",
                      "launches_per_call", "torch_ops_ms", "kernel_ms",
                      "kernel_roofline", "device_idle_pct")}
    assert read["rays_per_s"] == pytest.approx(2 * 1000 / 0.5 / 1e6)
    assert read["call_ms_p95"] == pytest.approx(110.0)
    assert read["launches_per_call"] == 1.0
    assert read["torch_ops_ms"] == pytest.approx(0.5)
    assert read["kernel_ms"] == pytest.approx(1.0)
    # 6.7 MB at 3.35 TB/s is 2 us, against 1 ms of kernels
    assert read["kernel_roofline"] == pytest.approx(0.2)
    assert read["device_idle_pct"] == pytest.approx(25.0)
    none = dataclasses_replace(run, trace=None, device_kind="cpu")
    for m in ("launches_per_call", "torch_ops_ms", "kernel_ms",
              "kernel_roofline", "device_idle_pct"):
        mod = importlib.import_module(f"rtbench.metrics.{m}")
        assert mod.read(none) is None


def dataclasses_replace(x, **kw):
    import dataclasses
    return dataclasses.replace(x, **kw)


def test_every_metric_has_a_reader():
    import importlib
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(importlib.import_module(
            f"rtbench.metrics.{m['name']}").read)
