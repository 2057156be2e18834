"""Answer kinds, one module per kind, found by the ``answer`` of a mix
(``traffic/<mix>.json``): what each call of the window is, which of its
answers are kept for the check, and how they are compared. Each module has

- ``call(pt, kwargs) -> f(scene, rays)``: the timed call;
- ``fields(out) -> dict``: what a call returned, by name, each a tensor
  over the rays (the harness copies its sampled rows after the call);
- ``reference(ref, prep, rays, idx, dtype) -> dict``: the plain
  reference's answers on the same rays (``ref``: a module of
  ``reference/``, ``prep`` its tables);
- ``as_answers(expected) -> dict``: a reference's answers in the form
  ``fields`` gives, so that the control can stand in the program's place;
- ``numbers(got, expected) -> dict``: the compared numbers, named in
  ``NUMBERS``, each of which a cell's ``limits/<cell>.json`` may bound."""
