"""The JAX package's examples on the port: ``python -m
embree_tpu_torch.examples.render_triangle_demo``, ``.render_pathtracer_demo``
and ``.feature_demos``. Each parses its arguments and touches the card only
inside ``main(argv=None)``, so importing one does nothing."""
