"""What the two ablation harnesses share: programs and padding, the
result, the plain PyTorch walk, the kernels' launcher and the report of
``main()`` (their loader, launch counts and timing: ``device``).

Both TPU harnesses run their rays in programs of UGRP x 128 rays (the
Pallas grid), each program in lockstep until its step limit (v7, and v5
with ``max_steps``) or until none of its rays is active (v5). A program
reports its lockstep step count ``it_final`` and, per step, how many
rounds its tile fetch loop took (the fetch trips). Only these are
properties of a program; every ray's own walk (its records, stack, t and
hit) depends on that ray alone, with one exception, v7's ``one_trip``
variant, where a 128-ray sub-group fetches one tile per step and the rays
that need another keep their stale record.

The walk of one ray, as both harnesses compute it per step:
- a ray at a node (cur >= 0) reads its node record (or, with the node
  fetch ablated, the zero record the buffers start with); node math: the
  slab test of the 8 children on bf16 bounds, keys (t bits with the low 3
  bits replaced by the child slot, INF | slot for a miss), h hit children;
  without node math (v7) a child "hits" when its ref is not empty, keyed
  by its slot, and (v5) none hits; the keys sorted (or not); the h - 1
  farther children pushed, farthest first, and the nearest taken next;
- a ray at a leaf reads its leaf record and runs the harness's leaf test;
- a ray with nothing next pops its stack (0, the root, when the stack is
  ablated) or retires when it is empty.
The stack holds 64 entries per ray. Its ninth 8-entry block, reached only
by a ray that pushes past 64, is a dynamic slice that XLA clamps onto rows
56-63: entries 64-71 alias 56-63, and entries from 72 on are dropped (read
as 0). Plain version and kernel reproduce this exactly.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from ..accel.traverse import _bf16_pairs, _jmax, _jmin
from ..accel.pack import INVALID_REC
from ..core.math import rcp_safe
from .device import load
from .tables import LANE, NODE_WORDS, AblateTables

INF_BITS = 0x7F800000
STACK = 64               # STACK_BLOCKS * 8 (v7), STACK_ROWS (v5)
STACK_REACH = 72         # the clamped ninth block: entries 64-71 alias 56-63
MAX_STEPS = 200_000      # traverse_pallas.MAX_STEPS, v5's runaway guard
UNWRITTEN = 0x7FC0DEAD   # the twin's t before a ray is finished

class AblateResult(NamedTuple):
    """The harness's outputs, (B, UGRP, 128) each, and the rays' steps."""
    t: torch.Tensor       # float32: t of the best hit, else tfar
    best: torch.Tensor    # int32: v7 slot id 8*leaf+slot, v5 prim id; -1
    steps: torch.Tensor   # int32: rows 0 and 3.. the program's lockstep
    #                       steps, row 1 node and row 2 leaf fetch trips
    visits: torch.Tensor  # (2, B*UGRP*128) int32: steps each ray took at a
    #                       node and at a leaf
    sched: Optional[torch.Tensor] = None  # the kernels' (and the twin's)
    #                       seven int64 work counts (``run_native``); None
    #                       from the plain version


def pad_rays(org, dir, tnear, tfar, mask, prog: int):
    """The harness's ``prep``: rays padded to whole programs of ``prog``
    rays (org 0, dir 1, tnear 1, tfar 0, mask 0: inactive), float32 /
    int32, contiguous. Returns (B, padded fields)."""
    R = org.shape[0]
    if tuple(dir.shape) != (R, 3) or tuple(org.shape) != (R, 3) or any(
            tuple(x.shape) != (R,) for x in (tnear, tfar, mask)):
        raise ValueError("rays must be org, dir (R, 3) and tnear, tfar, "
                         "mask (R,)")
    B = -(-R // prog)
    pad = B * prog - R

    def prep(x, fill, dtype):
        x = x.to(dtype)
        if pad:
            x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                         dtype=dtype, device=x.device)])
        return x.contiguous()

    f32, i32 = torch.float32, torch.int32
    return B, (prep(org, 0.0, f32), prep(dir, 1.0, f32), prep(tnear, 1.0, f32),
               prep(tfar, 0.0, f32), prep(mask, 0, i32))


def steps_rows(it_final, ntrips, ltrips, ugrp: int):
    """(B, UGRP, 128) int32: every row it_final, row 1 the node fetch
    trips, row 2 the leaf fetch trips (ablate_v7.py:302-304)."""
    B = it_final.shape[0]
    out = it_final.to(torch.int32).view(B, 1, 1).expand(B, ugrp, LANE).clone()
    out[:, 1] = ntrips.to(torch.int32).view(B, 1)
    out[:, 2] = ltrips.to(torch.int32).view(B, 1)
    return out


def check_tables(tables: AblateTables, leaf_words: int, device) -> None:
    """Raise unless ``tables`` hold whole tiles of int32 node records and
    float32 leaf records of ``leaf_words`` words, contiguous, on
    ``device``."""
    for name, x, dtype, words in (
            ("nodes", tables.nodes, torch.int32, NODE_WORDS),
            ("leaves", tables.leaves, torch.float32, leaf_words)):
        if x.device != device:
            raise ValueError(f"{name} are on {x.device}, rays on {device}")
        if x.dtype != dtype or x.ndim != 2 or x.shape[1] != words:
            raise ValueError(f"{name} must be ({LANE}k, {words}) {dtype}, "
                             f"got {tuple(x.shape)} {x.dtype}")
        if x.shape[0] < LANE or x.shape[0] % LANE:
            raise ValueError(f"{name} must hold whole tiles of {LANE}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned")


# ---------------------------------------------------------------------------
# the plain PyTorch walk
# ---------------------------------------------------------------------------

def rec_index(rec, n_tiles: int):
    """Record of id ``rec`` (>= 0) as the TPU fetch finds it: tile
    clip(rec // 128, 0, G - 1), lane rec % 128."""
    rec = rec.long()
    return torch.clamp(rec // LANE, 0, n_tiles - 1) * LANE + rec % LANE


def tile_of(rec, n_tiles: int):
    return torch.clamp(rec.long() // LANE, 0, n_tiles - 1)


def _distinct(tiles, need, sentinel: int):
    """Distinct tiles the needing entries of each row ask for: (G, n) ->
    (G,)."""
    s = torch.sort(torch.where(need, tiles, sentinel), dim=1).values
    first = (s[:, :1] != sentinel).long().sum(1)
    new = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] != sentinel)).long().sum(1)
    return first + new


def _records(table, idx):
    """Rows ``idx`` of a record table, zero where idx < 0 (the zeroed
    buffer of a ray that has fetched nothing)."""
    rec = table[idx.clamp(min=0)]
    return torch.where((idx >= 0)[:, None], rec, torch.zeros_like(rec))


def _stack_col(p):
    """Stack column of entry p: p below 64, p - 8 for 64-71, the spare
    column 64 (never read) from 72 on."""
    return torch.where(p < STACK, p,
                       torch.where(p < STACK_REACH, p - 8,
                                   torch.full_like(p, STACK)))


def _peek(stack, rows, p):
    v = stack[rows, _stack_col(p.clamp(min=0))]
    return torch.where((p >= 0) & (p < STACK_REACH), v, torch.zeros_like(v))


def walk_plain(tables: AblateTables, rays, prog: int, *, fetch_node: bool,
               fetch_leaf: bool, node_math: str,
               leaf_fn: Optional[Callable[..., tuple]],
               sort: bool, stack_on: bool, one_trip: bool, max_steps: int,
               trips: str):
    """The per-step walk of every ray of ``rays`` (padded to whole
    programs of ``prog`` rays), all programs side by side.

    node_math: "slab" (the slab test), "refs" (v7 without node math) or
    "none" (v5 without it); leaf_fn(rec, org, dir, tnear, tf, mask) ->
    (found, t_new, best_new) over the rays at a leaf, or None (no leaf
    math); trips: "subgroup" (v7: the most distinct tiles any 128-ray
    sub-group needs) or "program" (v5: the program's distinct tiles);
    one_trip: v7's single fetch round per step. Returns (tf, best, visits,
    ntrips (B,), ltrips (B,))."""
    org, dir, tnear, tfar, mask = rays
    dev = org.device
    R = org.shape[0]
    B = R // prog
    gn, gl = tables.n_node_tiles, tables.n_leaf_tiles
    nodes, leaves = tables.nodes, tables.leaves
    rd = rcp_safe(dir)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    slot = torch.arange(8, dtype=torch.int32, device=dev)
    push_l = torch.arange(7, device=dev)
    tf = tfar.clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((2, R), dtype=torch.int32, device=dev)
    # column STACK takes the pushes from entry 72 on (never read)
    stack = torch.zeros((R, STACK + 1), dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    cur = torch.zeros(R, dtype=torch.int32, device=dev)
    nidx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    lidx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    act = tnear <= tfar
    ntrips = torch.zeros(B, dtype=torch.int64, device=dev)
    ltrips = torch.zeros(B, dtype=torch.int64, device=dev)
    group = LANE if trips == "subgroup" else prog

    def trips_of(tiles, need, n_tiles):
        d = _distinct(tiles.view(-1, group), need.view(-1, group), n_tiles)
        return d.view(B, -1).amax(1)

    def served(tiles, need, n_tiles):
        if not one_trip:
            return need
        t = torch.where(need, tiles, n_tiles).view(-1, LANE)
        return need & (tiles == t.amin(1, keepdim=True).expand_as(t)
                       .reshape(-1))

    steps = 0
    while steps < max_steps and bool(act.any()):
        steps += 1
        at_node = act & (cur >= 0)
        at_leaf = act & (cur < 0)
        visits[0] += at_node.int()
        visits[1] += at_leaf.int()
        ncur = torch.where(at_node, cur, 0)
        lcur = torch.where(at_leaf, -cur - 1, 0)
        if fetch_node:
            tiles = tile_of(ncur, gn)
            if not one_trip:
                ntrips += trips_of(tiles, at_node, gn)
            nidx = torch.where(served(tiles, at_node, gn),
                               rec_index(ncur, gn), nidx)
        if fetch_leaf:
            tiles = tile_of(lcur, gl)
            if not one_trip:
                ltrips += trips_of(tiles, at_leaf, gl)
            lidx = torch.where(served(tiles, at_leaf, gl),
                               rec_index(lcur, gl), lidx)
        pop = torch.zeros_like(act)

        # ---- nodes ----
        ni = at_node.nonzero().squeeze(1)
        if ni.numel():
            rec = _records(nodes, nidx[ni])
            refs = rec[:, :8]
            if node_math == "slab":
                lo, hi = _bf16_pairs(rec[:, 8:].reshape(-1, 3, 8))
                o = org[ni].unsqueeze(2)
                r = rd[ni].unsqueeze(2)
                t0 = (lo - o) * r
                t1 = (hi - o) * r
                tmin = _jmin(t0, t1)
                tmax = _jmax(t0, t1)
                tent = _jmax(_jmax(tmin[:, 0], tmin[:, 1]),
                             _jmax(tmin[:, 2], tnear[ni, None]))
                tex = _jmin(_jmin(tmax[:, 0], tmax[:, 1]),
                            _jmin(tmax[:, 2], tf[ni, None]))
                hit = (tent <= tex) & (refs != int(INVALID_REC))
                kd = _jmax(tent, zero).view(torch.int32)
                key = torch.where(hit, (kd & ~7) | slot, INF_BITS | slot)
            elif node_math == "refs":
                hit = refs != int(INVALID_REC)
                key = torch.where(hit, slot, INF_BITS | slot)
            else:
                hit = torch.zeros_like(refs, dtype=torch.bool)
                key = slot.expand_as(refs)
            h = hit.sum(1)
            if sort:
                # keys are distinct (the slot rides in the low bits), so
                # any sort gives the bitonic network's order
                sref = refs.gather(1, (torch.sort(key, dim=1).values & 7)
                                   .long())
            else:
                sref = refs
            spn = sp[ni]
            npush = torch.clamp(h - 1, min=0)
            if stack_on:
                # entry sp + l gets sorted[h - 1 - l] for l < h - 1
                pos = spn[:, None] + push_l
                item = sref.gather(1, (h[:, None] - 1 - push_l).clamp(0, 7))
                col = torch.where(push_l < npush[:, None], _stack_col(pos),
                                  STACK)
                stack[ni[:, None], col] = item
            new_sp = spn + npush
            has = h > 0
            sp[ni] = new_sp
            cur[ni] = torch.where(has, sref[:, 0], cur[ni])
            pop[ni] = ~has

        # ---- leaves ----
        li = at_leaf.nonzero().squeeze(1)
        if li.numel() and leaf_fn is not None:
            rec = _records(leaves, lidx[li])
            found, t_new, b_new = leaf_fn(rec, org[li], dir[li], tnear[li],
                                          tf[li], mask[li], lcur[li])
            tf[li] = torch.where(found, t_new, tf[li])
            best[li] = torch.where(found, b_new, best[li])
        pop |= at_leaf

        # ---- pop or retire ----
        can = pop & (sp > 0)
        if stack_on:
            popped = _peek(stack, torch.arange(R, device=dev), sp - 1)
        else:
            popped = torch.zeros_like(cur)
        cur = torch.where(can, popped, cur)
        sp = torch.where(can, sp - 1, sp)
        act = act & ~(pop & ~can)

    if one_trip:
        # one round per step, needed or not, for every pinned step
        ntrips += max_steps if fetch_node else 0
        ltrips += max_steps if fetch_leaf else 0
    return tf, best, visits, ntrips, ltrips


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
         + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
         + [ctypes.c_int])
# the work counts of a launch (csrc/ablate.cuh::run_warp)
SCHED = ("lane_slots", "lane_steps", "rays_finished", "warps_per_sm",
         "leaf_lane_slots", "leaf_lane_steps", "item_slots")


def _load(target: str, fn: str, extra=()):
    return load(target, fn, _ARGS + list(extra))


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def run_native(unit: str, tables: AblateTables, rays, prog: int,
               max_steps: int, flags: int):
    """Launch the CUDA kernel (CUDA rays) or run its g++ twin (CPU rays)
    of ``unit`` ("v7" or "v5") on R rays, whole programs of ``prog`` or
    not. Returns (tf, best, visits, the most steps any ray of each program
    took (ceil(R / prog),), the launch's work counts (7,) int64: ``SCHED``)."""
    org = rays[0]
    R = org.shape[0]
    dev = org.device

    def out(shape, unwritten):
        # the twin's outputs start as values no walk writes (a NaN payload,
        # an id below -1, negative steps), so a ray it never finished shows
        if dev.type == "cpu":
            return torch.full(shape, unwritten, dtype=torch.int32, device=dev)
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out_t = out((R,), UNWRITTEN).view(torch.float32)
    out_best = out((R,), -2)
    visits = out((2, R), -1)
    prog_steps = torch.zeros(-(-R // prog), dtype=torch.int32, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    counts = torch.zeros(len(SCHED), dtype=torch.int64, device=dev)
    args = [_ptr(tables.nodes), tables.n_node_tiles, _ptr(tables.leaves),
            tables.n_leaf_tiles] + [_ptr(x) for x in rays] + [
        R, prog, max_steps, _ptr(out_t), _ptr(out_best), _ptr(visits),
        _ptr(prog_steps), _ptr(next_ray), _ptr(counts), flags]
    if dev.type == "cuda":
        launch = _load("ablate_cuda", f"ablate_{unit}_launch",
                       [ctypes.c_void_p])
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"ablation kernel {unit} launch failed: "
                               f"CUDA error {err}")
    elif dev.type == "cpu":
        if _load("ablate_twin", f"ablate_{unit}_twin")(*args) != 0:
            raise ValueError(f"{unit}: no such variant (flags {flags:#x}) "
                             "or launch shape")
    else:
        raise ValueError(f"no ablation kernel for device {dev}")
    return out_t, out_best, visits, prog_steps, counts


# ---------------------------------------------------------------------------
# the report of main()
# ---------------------------------------------------------------------------

def report(name: str, ms: float, res: AblateResult, ugrp: int) -> dict:
    """One variant's line of ``main()``: ms, the programs' lockstep steps
    (the harness's ``steps``), ns per program step and per ray step."""
    prog_steps = int(res.steps[:, 0, 0].sum(dtype=torch.int64))
    ray_steps = int(res.visits.sum(dtype=torch.int64))
    rec = dict(name=name, ms=ms, program_steps=prog_steps,
               ray_steps=ray_steps,
               ns_per_program_step=ms * 1e6 / max(prog_steps, 1),
               ns_per_ray_step=ms * 1e6 / max(ray_steps, 1), ugrp=ugrp)
    print(f"{name:16s} {ms:9.3f} ms  steps {prog_steps}  "
          f"{rec['ns_per_program_step']:9.1f} ns/step  ray steps {ray_steps}"
          f"  {rec['ns_per_ray_step']:7.3f} ns/ray-step", flush=True)
    return rec
