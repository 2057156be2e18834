"""Models-tier image parity: Embree's ``.ecs`` command files through the
viewer's default shader.

Port of embree_tpu/tools/parity_models.py. The reference renders each
``.ecs`` file (camera and scene XML, or procedural spheres) through
embree_viewer's DEFAULT shader (viewer_device.cpp:204 renderPixelStandard:
color = material Kd * dot(-dir, faceforward(Ns)); background black; moving
scenes sample a per-pixel random time with the MurmurHash3 + LCG
RandomSampler, random_sampler.h) and keeps ``<name>.ecs.embree_viewer.exr``
goldens at 512x512. This tool does the same through the port's
``intersect``, on the card unless asked for the CPU, and scores each image
with the reference's 8-bit wrong-pixel metric.

Usage:
  python -m embree_tpu_torch.tools.parity_models SCENE_DIR
      [--glob '*/*.ecs'] [--out models_parity.json] [--threshold 55]
      [--size 512] [--limit N] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob as globmod
import json
import os
import sys
import time

import numpy as np
import torch


def parse_ecs(path):
    """Parse the .ecs command file: -i scene.xml + camera flags."""
    toks = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue
            toks += line.split()
    out = dict(xml=None, vp=None, vi=None, vu=(0.0, 1.0, 0.0), fov=90.0,
               lefthanded=False, shader="default", camera=None,
               min_width=0.0, max_radius_scale=1.0, point_spheres=[],
               prim_spheres=[])
    i = 0
    while i < len(toks):
        t = toks[i].lstrip("-")
        if t == "i":
            out["xml"] = os.path.join(os.path.dirname(path), toks[i + 1])
            i += 2
        elif t in ("vp", "vi", "vu"):
            out[t] = tuple(float(x) for x in toks[i + 1:i + 4])
            i += 4
        elif t == "fov":
            out["fov"] = float(toks[i + 1])
            i += 2
        elif t == "shader":
            out["shader"] = toks[i + 1]
            i += 2
        elif t == "camera":
            out["camera"] = toks[i + 1]
            i += 2
        elif t == "lefthanded":
            out["lefthanded"] = True
            i += 1
        elif t == "min-width":
            out["min_width"] = float(toks[i + 1])
            out["max_radius_scale"] = float(toks[i + 2])
            i += 3
        elif t in ("point-sphere", "disc-sphere", "oriented-disc-sphere"):
            kind = {"point-sphere": "sphere", "disc-sphere": "disc",
                    "oriented-disc-sphere": "oriented_disc"}[t]
            vals = [float(x) for x in toks[i + 1:i + 7]]
            out["point_spheres"].append((kind, vals[:3], vals[3], vals[4],
                                         int(vals[5])))
            i += 7
        elif t in ("triangle-sphere", "quad-sphere", "grid-sphere"):
            vals = [float(x) for x in toks[i + 1:i + 6]]
            out["prim_spheres"].append((t.split("-")[0], vals[:3], vals[3],
                                        int(vals[4])))
            i += 6
        else:
            i += 1
    return out


def _sphere_grid(center, radius, num_phi):
    """The (num_phi + 1) x 2 num_phi latitude-longitude grid of the
    tutorials' spheres (float64 arithmetic on a float32 center)."""
    n_phi = int(num_phi)
    n_theta = 2 * n_phi
    phi = np.arange(n_phi + 1)[:, None] * np.pi / n_phi
    theta = np.arange(n_theta)[None, :] * 2.0 * np.pi / n_theta
    c = np.asarray(center, np.float32)
    x = c[0] + radius * np.sin(phi) * np.sin(theta)
    y = (c[1] + radius * np.cos(phi)) * np.ones_like(theta)
    z = c[2] + radius * np.sin(phi) * np.cos(theta)
    return c, x, y, z


def point_sphere(center, radius, point_r, num_phi, oriented=False):
    """createPointSphere (geometry_creation.cpp:361): a num_phi x
    2 num_phi grid of points, as arrays: (P, 4) float32 centers and radii,
    and (P, 3) radial normals when ``oriented`` (else None)."""
    c, x, y, z = _sphere_grid(center, radius, num_phi)
    pos = np.stack([x, y, z, np.full_like(x, point_r)], -1).reshape(-1, 4)
    pos = pos.astype(np.float32)
    if not oriented:
        return pos, None
    nrm = (pos[:, :3] - c)
    return pos, (nrm / np.maximum(
        np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    ).astype(np.float32)


def _point_sphere(kind, center, radius, point_r, num_phi):
    """The procedural sphere of points as a PointGeometry of ``kind``."""
    from ..geometry import PointGeometry
    pos, normals = point_sphere(center, radius, point_r, num_phi,
                                oriented=kind == "oriented_disc")
    return PointGeometry(pos, kind=kind, normals=normals)


_GRID_FRAMES = (  # p0, dx, dy per cube face (createGridSphere)
    ((-0.5, -0.5, -0.5), (1, 0, 0), (0, 1, 0)),
    ((+0.5, -0.5, -0.5), (0, 0, 1), (0, 1, 0)),
    ((+0.5, -0.5, +0.5), (-1, 0, 0), (0, 1, 0)),
    ((-0.5, -0.5, +0.5), (0, 0, -1), (0, 1, 0)),
    ((-0.5, -0.5, -0.5), (0, 0, 1), (1, 0, 0)),
    ((-0.5, +0.5, -0.5), (1, 0, 0), (0, 0, 1)),
)


def prim_sphere(shape, center, radius, num_phi):
    """createTriangleSphere / createQuadSphere / createGridSphere
    (geometry_creation.cpp) as arrays, with the reference's vertex layout
    and index quirks (the pole bands reference arbitrary coincident
    pole-row vertices): (V, 3) float32 vertices and (N, 3) triangles,
    (N, 4) quads, or (6, 4) grid rows for ``shape == "grid"``."""
    if shape == "grid":
        N = int(num_phi)
        c = np.asarray(center, np.float32)
        gs = (N + 1) * (N + 1)
        pos = np.zeros((6 * gs, 3), np.float32)
        grids = []
        t = np.arange(N + 1, dtype=np.float32) / N
        for i, (p0, dx, dy) in enumerate(_GRID_FRAMES):
            p = (np.asarray(p0, np.float32)
                 + t[None, :, None] * np.asarray(dx, np.float32)
                 + t[:, None, None] * np.asarray(dy, np.float32))
            p = p / np.linalg.norm(p, axis=-1, keepdims=True)
            pos[i * gs:(i + 1) * gs] = (c + radius * p).reshape(-1, 3)
            grids.append([i * gs, N + 1, N + 1, N + 1])
        return pos, np.asarray(grids, np.int32)
    n_phi = int(num_phi)
    n_theta = 2 * n_phi
    _, x, y, z = _sphere_grid(center, radius, num_phi)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    th = np.arange(1, n_theta + 1)
    quad = shape == "quad"
    rows = []
    for p in range(1, n_phi + 1):
        p00 = (p - 1) * n_theta + th - 1
        p01 = (p - 1) * n_theta + th % n_theta
        p10 = p * n_theta + th - 1
        p11 = p * n_theta + th % n_theta
        if p == 1 or p == n_phi:
            if p == 1:      # pole-row quirk
                a, b, d = p10, np.full_like(p10, n_theta - 1), p11
            else:
                a, b, d = np.full_like(p00, n_phi * n_theta), p00, p01
            rows.append(np.stack([a, b, d, d] if quad else [a, b, d], -1))
        elif quad:
            rows.append(np.stack([p10, p00, p01, p11], -1))
        else:
            rows.append(np.stack([np.stack([p10, p00, p11], -1),
                                  np.stack([p01, p11, p00], -1)], 1)
                        .reshape(-1, 3))
    return pos, np.concatenate(rows).astype(np.int32)


def _prim_sphere(shape, center, radius, num_phi):
    """The procedural triangle, quad or grid sphere as a geometry."""
    from ..geometry import GridGeometry, QuadGeometry, TriangleGeometry
    pos, idx = prim_sphere(shape, center, radius, num_phi)
    cls = {"grid": GridGeometry, "quad": QuadGeometry}.get(
        shape, TriangleGeometry)
    return cls(pos, idx)


def _pixel_times(width, height):
    """Per-pixel ray time for motion scenes: RandomSampler_init(x,y,0) then
    get1D (random_sampler.h MurmurHash3 + LCG) — bit-exact."""
    x = np.arange(width, dtype=np.uint32)[None, :]
    y = np.arange(height, dtype=np.uint32)[:, None]
    pixel_id = (x | (y << np.uint32(16))).astype(np.uint32)

    def mix(h, k):
        k = (k * np.uint32(0xcc9e2d51)).astype(np.uint32)
        k = ((k << np.uint32(15)) | (k >> np.uint32(17))).astype(np.uint32)
        k = (k * np.uint32(0x1b873593)).astype(np.uint32)
        h = (h ^ k).astype(np.uint32)
        h = (((h << np.uint32(13)) | (h >> np.uint32(19))).astype(np.uint32)
             * np.uint32(5) + np.uint32(0xe6546b64)).astype(np.uint32)
        return h

    def fin(h):
        h = (h ^ (h >> np.uint32(16))).astype(np.uint32)
        h = (h * np.uint32(0x85ebca6b)).astype(np.uint32)
        h = (h ^ (h >> np.uint32(13))).astype(np.uint32)
        h = (h * np.uint32(0xc2b2ae35)).astype(np.uint32)
        return (h ^ (h >> np.uint32(16))).astype(np.uint32)

    with np.errstate(over="ignore"):
        s = fin(mix(mix(np.uint32(0), pixel_id), np.uint32(0)))
        s = (s * np.uint32(1664525) + np.uint32(1013904223)).astype(np.uint32)
    return ((s >> np.uint32(1)).astype(np.float32)
            * np.float32(4.656612873077392578125e-10))


def _texcoord_tables(geometries):
    """The texcoords shaders' tables (viewer_device_debug.cpp:268-285):
    the texcoord attribute is itself Catmull-Clark subdivided with its own
    topology and boundary mode (scene_subdiv_mesh.h vertex attributes;
    subdiv_mode= on texcoord_indices). The texcoord mesh is refined beside
    the positions (final quad k of face f matches 1:1) and each quad's st
    corners are scattered into a per-face (res+1)^2 grid over the face's uv
    through the quads' uv frames. Returns (tabs (G, F, r, r, 2), res (G,),
    has (G,)) in numpy."""
    from ..ops.subdiv import catmull_clark
    tabs = []
    maxf, maxr = 1, 2
    for g in geometries:
        tcs = getattr(g, "texcoords", None)
        tci = getattr(g, "texcoord_indices", None)
        fcs = getattr(g, "face_counts", None)
        if tcs is None or tci is None or fcs is None:
            tabs.append(None)
            continue
        tcs3 = np.concatenate([np.asarray(tcs, np.float32),
                               np.zeros((len(tcs), 1), np.float32)], -1)
        mode = getattr(g, "texcoord_mode", None) or "smooth"
        tv, tq, tqb, tquvm = catmull_clark(
            tcs3, np.asarray(fcs, np.int64), np.asarray(tci, np.int64),
            levels=g.levels + 2, to_limit=False, boundary_mode=mode,
            boundary_interpolation=(mode != "no_boundary"))
        F = len(np.asarray(fcs))
        res = int(round(np.sqrt(max(int((tqb == 0).sum()), 1))))
        grid = np.zeros((F, res + 1, res + 1, 2), np.float32)
        corners = tv[tq][..., :2]                     # (Q, 4, 2)
        # refinement ROTATES child quads (each child's v0 is the parent
        # corner), so scatter every corner by its own uv from the quad
        # frame: uv0=(m0,m1), uv1=uv0+(m2,m3), uv3=uv0+(m4,m5),
        # uv2=uv1+uv3-uv0 (cells are axis-aligned parallelograms)
        u0 = tquvm[:, 0:2]
        u1 = u0 + tquvm[:, 2:4]
        u3 = u0 + tquvm[:, 4:6]
        u2 = u1 + u3 - u0
        for c, uvc in enumerate((u0, u1, u2, u3)):
            ii = np.clip(np.round(uvc[:, 0] * res).astype(int), 0, res)
            jj = np.clip(np.round(uvc[:, 1] * res).astype(int), 0, res)
            grid[tqb, jj, ii] = corners[:, c]
        tabs.append(grid)
        maxf = max(maxf, F)
        maxr = max(maxr, res + 1)
    tc_tabs = np.zeros((len(tabs), maxf, maxr, maxr, 2), np.float32)
    tc_res = np.ones(len(tabs), np.float32)
    tc_has = np.zeros(len(tabs), bool)
    for gi, tab in enumerate(tabs):
        if tab is not None:
            tc_tabs[gi, :tab.shape[0], :tab.shape[1], :tab.shape[2]] = tab
            tc_res[gi] = tab.shape[1] - 1
            tc_has[gi] = True
    return tc_tabs, tc_res, tc_has


def _shade_texcoords(hits, shader, tabs, res_g, has_g):
    """The texcoords / texcoords-grid shaders over the tables of
    ``_texcoord_tables`` (on the hits' device): a bilinear st lookup at the
    hit's face uv; misses blue, geometries without texcoords white."""
    dev = hits.t.device
    gid = hits.geom_id.clamp(0, tabs.shape[0] - 1)
    fid = hits.prim_id.clamp(0, tabs.shape[1] - 1)
    res = res_g[gid]
    xg = hits.u.clamp(0.0, 1.0) * res
    yg = hits.v.clamp(0.0, 1.0) * res
    x0 = torch.minimum(torch.clamp(torch.floor(xg), min=0), res - 1).long()
    y0 = torch.minimum(torch.clamp(torch.floor(yg), min=0), res - 1).long()
    fx = (xg - x0)[..., None]
    fy = (yg - y0)[..., None]
    g00 = tabs[gid, fid, y0, x0]
    g01 = tabs[gid, fid, y0, x0 + 1]
    g10 = tabs[gid, fid, y0 + 1, x0]
    g11 = tabs[gid, fid, y0 + 1, x0 + 1]
    st = ((1 - fy) * ((1 - fx) * g00 + fx * g01)
          + fy * ((1 - fx) * g10 + fx * g11))
    if shader == "texcoords":
        col = torch.stack([st[..., 0], st[..., 1],
                           torch.zeros_like(st[..., 0])], -1)
    else:
        # ((int)(10*s)+(int)(10*t)) % 2: C int cast truncates to 0
        a = torch.trunc(10.0 * st[..., 0]).to(torch.int32)
        b = torch.trunc(10.0 * st[..., 1]).to(torch.int32)
        red = torch.remainder(a + b, 2) == 0
        col = torch.where(red[..., None],
                          torch.tensor([1.0, 0.0, 0.0], device=dev),
                          torch.tensor([0.0, 1.0, 0.0], device=dev))
    col = torch.where(has_g[gid][..., None], col, 1.0)
    return torch.where(hits.valid[..., None], col,
                       torch.tensor([0.0, 0.0, 1.0], device=dev))


def _shade_default(rays, hits, kd):
    """The viewer's default shader: Kd * dot(-dir, faceforward(Ng))."""
    ng = hits.ng
    ng = ng * torch.rsqrt(torch.clamp((ng * ng).sum(-1, keepdim=True),
                                      min=1e-30))
    shade = (-rays.dir * ng).sum(-1).abs()   # face_forward, dot(-d, Ns)
    gid = hits.geom_id.clamp(0, kd.shape[0] - 1)
    col = kd[gid] * shade[..., None]
    return torch.where(hits.valid[..., None], col, 0.0)


def run_ecs(ecs_path, size=512, device=None):
    """Render one .ecs file at size x size: (size, size, 3) float32 numpy.
    Rows are traced PARITY_CHUNK_ROWS (64) at a time, as the JAX tool
    chunks them."""
    from ..core.ray import RayBatch
    from ..models.viewer import SHADERS, ispc_camera_rays
    from ..scene import intersect
    from ..utils.xml_scene import XMLScene, load_xml, to_scene

    cfg = parse_ecs(ecs_path)
    xs = load_xml(cfg["xml"]) if cfg["xml"] is not None else XMLScene()
    for kind, c, r, pr, nphi in cfg["point_spheres"]:
        xs.geometries.append(_point_sphere(kind, c, r, pr, nphi))
        # OBJMaterial default Kd is white (measured vs goldens)
        xs.kd.append(np.array([1.0, 1.0, 1.0], np.float32))
    for shape, c, r, nphi in cfg["prim_spheres"]:
        xs.geometries.append(_prim_sphere(shape, c, r, nphi))
        xs.kd.append(np.array([1.0, 1.0, 1.0], np.float32))
    if not xs.geometries:
        raise ValueError("no geometries parsed")
    kw = {}
    if cfg["min_width"] > 0.0:
        # viewer: args.minWidthDistanceFactor = 0.5*min_width/width
        kw = dict(min_width_factor=0.5 * cfg["min_width"] / size,
                  max_radius_scale=cfg["max_radius_scale"])
    cs = to_scene(xs, **kw).commit(device=device)
    dev = cs.device
    cam = (xs.cameras.get(cfg["camera"]) if cfg["camera"] else None) \
        or xs.camera or {}
    vp = cfg["vp"] or tuple(cam.get("from_", (0.0001, 0.0001, -3.0)))
    vi = cfg["vi"] or tuple(cam.get("to", (0.0, 0.0, 0.0)))
    if cfg["vp"] is None and "up" in cam:
        cfg = dict(cfg, vu=tuple(cam["up"]), fov=cam["fov"])
    kd = torch.as_tensor(np.stack(xs.kd).astype(np.float32), device=dev)
    times = (torch.from_numpy(_pixel_times(size, size)).to(dev)
             if cs.has_motion else 0.0)
    rows_chunk = int(os.environ.get("PARITY_CHUNK_ROWS", 64))
    tex = None
    if cfg["shader"] in ("texcoords", "texcoords-grid"):
        tex = tuple(torch.as_tensor(a, device=dev)
                    for a in _texcoord_tables(xs.geometries))

    rays_full = ispc_camera_rays(np.asarray(vp), np.asarray(vi),
                                 np.asarray(cfg["vu"]), cfg["fov"], size,
                                 size, time=times, device=dev)
    out = np.zeros((size, size, 3), np.float32)
    for y0 in range(0, size, rows_chunk):
        rays = RayBatch(*(getattr(rays_full, f.name)[y0:y0 + rows_chunk]
                          for f in dataclasses.fields(RayBatch)))
        hits = intersect(cs, rays)
        if tex is not None:
            col = _shade_texcoords(hits, cfg["shader"], *tex)
        elif cfg["shader"] != "default":
            col = SHADERS[cfg["shader"]](cs, rays, hits)
        else:
            col = _shade_default(rays, hits, kd)
        out[y0:y0 + rows_chunk] = col.cpu().numpy()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render .ecs scenes and score them against their "
                    "<name>.ecs.embree_viewer.exr goldens")
    ap.add_argument("scene_dir", help="directory holding the .ecs files")
    ap.add_argument("--glob", default=os.path.join("*", "*.ecs"),
                    help="pattern under SCENE_DIR")
    ap.add_argument("--out", default="models_parity.json")
    ap.add_argument("--threshold", type=float, default=55.0)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the plain versions)")
    args = ap.parse_args(argv)
    from ..utils.exr import compare_images, quantize8, read_exr
    device = "cpu" if args.cpu else None

    results = {}
    n_pass = n_fail = n_skip = 0
    ecss = sorted(globmod.glob(os.path.join(args.scene_dir, args.glob)))
    if args.limit:
        ecss = ecss[:args.limit]
    for ecs in ecss:
        name = os.path.relpath(ecs, args.scene_dir)
        t0 = time.time()
        pc = parse_ecs(ecs)
        if (pc["xml"] is None and not pc["point_spheres"]
                and not pc["prim_spheres"]):
            results[name] = "SKIP: no scene input"
            n_skip += 1
            print(f"{name}: SKIP (no scene input)", flush=True)
            continue
        has_gold = os.path.exists(ecs + ".embree_viewer.exr")
        try:
            img = run_ecs(ecs, size=args.size, device=device)
            if has_gold:
                gold = read_exr(ecs + ".embree_viewer.exr")
                err = compare_images(quantize8(img), gold)
                ok = err <= args.threshold
                results[name] = round(err, 2)
            else:
                # no golden for this scene (the reference ships none for
                # its garbage-input pair): it must render to a finite image
                finite = bool(np.isfinite(img).all())
                cover = float(np.mean(img.sum(-1) > 0))
                ok = finite
                results[name] = (f"SMOKE {'ok' if finite else 'NONFINITE'}:"
                                 f" cover={cover:.3f}")
            n_pass += ok
            n_fail += not ok
            print(f"{name}: {results[name]} [{time.time()-t0:.0f}s] "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
        except FileNotFoundError as e:
            # the scene names an asset its directory does not hold:
            # unrunnable for the reference viewer too, a skip
            results[name] = f"SKIP: missing input ({e.filename})"
            n_skip += 1
            print(f"{name}: SKIP missing input {e.filename}", flush=True)
        except Exception as e:  # noqa: BLE001 — record, count, go on
            results[name] = f"ERROR {type(e).__name__}: {e}"
            n_fail += 1
            print(f"{name}: ERROR {e}", flush=True)
        # incremental dump: a long run keeps what it measured
        with open(args.out, "w") as f:
            json.dump({"pass": n_pass, "fail": n_fail, "skip": n_skip,
                       "partial": True, "threshold": args.threshold,
                       "results": results}, f, indent=1)
    with open(args.out, "w") as f:
        json.dump({"pass": n_pass, "fail": n_fail, "skip": n_skip,
                   "threshold": args.threshold, "results": results}, f,
                  indent=1)
    print(f"\n{n_pass}/{n_pass+n_fail} model goldens within "
          f"{args.threshold} ({n_skip} skipped); -> {args.out}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
