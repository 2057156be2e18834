"""Multi-device rendering and training on torch.distributed.

Port of embree_tpu/parallel: ``render.py`` (process-group bring-up, the
ray-sharded mesh, the sharded render and the scaling measurements) and
``mesh.py`` (the depth loss and the data-parallel training step). Importing
this package starts no process group: ``render.init_distributed`` does.
"""
