"""The one traffic generator: it reads a mix's ``traffic/<mix>.json`` and
makes its pool of ray batches from the seed, on the device, with a
``torch.Generator`` there. The mix's ``rays.kind`` names the module of
``rays/`` that draws a batch; its ``answer`` names the module of
``answers/`` that makes each call and compares what it returns."""
from __future__ import annotations

import importlib
import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_SEED = (1 << 63) - 1


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def ray_kind(mix: dict):
    return importlib.import_module(f"rtbench.rays.{mix['rays']['kind']}")


def answer_kind(mix: dict):
    return importlib.import_module(f"rtbench.answers.{mix['answer']}")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % MAX_SEED)
    return g


def n_rays(mix: dict) -> int:
    return ray_kind(mix).count(mix["rays"])


def make_pool(mix: dict, seed: int, device, pt):
    """The mix's ``batches`` ray batches (``pt.RayBatch``) for the seed."""
    kind = ray_kind(mix)
    g = generator(seed, 0, device)
    return [kind.make(mix["rays"], g, device, pt)
            for _ in range(mix["batches"])]


def sample(n: int, per_batch: int, batches: int, seed: int, device):
    """The rays each batch's answers are checked on: ``per_batch`` distinct
    indices a batch, sorted, drawn from the seed."""
    g = generator(seed, 1, device)
    k = min(per_batch, n)
    return [torch.sort(torch.randperm(n, generator=g, device=device)[:k])
            .values for _ in range(batches)]
