"""The JAX package's tutorials through the port's API.

Each module mirrors one of ``tutorials/tutorial_*.py`` (the reference's
notebook series): ``run(device=None, dtype=torch.float64)`` returns every
number the tutorial prints, at full precision, and ``main(argv=None)``
prints them as the JAX tutorial does.  They run on the card unless
``--device cpu``; nothing runs at import.

    python -m albatross_tpu_torch.tutorials.tutorial_1_one_dimension --device cpu

Where they differ from the JAX tutorials, and why, is in
``albatross_tpu_torch.examples``'s docstring.
"""
