"""Native (C++) host oracle and ``.mats`` parser, loaded through ctypes.

Counterpart of ``cuda_matrix_inversion_tpu/native``: ``oracle.cpp`` and
``matsio.cpp`` are byte-identical copies of that package's sources.  Build
with ``python -m cuda_matrix_inversion_tpu_torch.native.build`` (or
:func:`build.ensure_built`); the library lands in ``build/torch_native/``
at the root of the checkout.  Nothing needs it: the ``*_native_cpu`` lanes
are registered only once it loads.
"""
