"""The JAX package's examples through the port's API.

Each module mirrors one of ``examples/*.py``: ``run(...)`` returns every
number the example prints, at full precision, and ``main(argv=None)``
takes the same arguments plus ``--device`` and prints what the JAX
example prints.  They run on the card unless ``--device cpu`` (without a
GPU they raise), at the JAX example's dtype (f64, but ``accuracy``'s f32
data), from the same numpy draws.  Nothing runs at import.

    python -m albatross_tpu_torch.examples.sinc --device cpu
    python -m albatross_tpu_torch.examples --device cpu   # every example

Where the port differs from the JAX examples, and why:

- Random streams.  The sampler's chain and tutorial 1's prior draws come
  from a ``torch.Generator`` seeded with the JAX example's integer key;
  JAX's counter-based keys give other numbers, so the chain matches JAX's
  only in distribution, and ``utils.sample_mvn`` takes JAX's normals
  through ``normals=`` where a caller needs the same draws.
- ``jax.grad`` over a model object.  The pytree protocol is not ported
  (ROADMAP, "Not to port"); tutorial 2 differentiates the parameter
  values themselves with autograd, which is what ``jax.grad`` of the
  model returns (not the gradient in the tunable vector's log space).
- ``jax.disable_jit``.  The accuracy example's double-word row runs
  eagerly on the JAX CPU backend because XLA's fusion breaks its
  error-free transforms under ``jit``; the port has no tracing, so the row
  runs as it is.
- ``XLA_FLAGS`` device counts.  The distributed example needs 8 devices
  for its (4, 2) mesh; the JAX example fakes them on the CPU, the port
  spawns a world of 8 gloo ranks (``torch.multiprocessing``), which share
  the card, or uses the world it is started in (``torchrun``).
"""
