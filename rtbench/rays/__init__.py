"""Ray kinds, one module per kind, found by the ``rays.kind`` of a mix
(``traffic/<mix>.json``). Each module has

- ``count(spec) -> int``: the rays of one batch;
- ``make(spec, g, device, pt) -> pt.RayBatch``: one batch, drawn with the
  ``torch.Generator`` ``g`` on ``device`` (``pt``: embree_tpu_torch).

Every seed gives the same sizes; only the values move."""
