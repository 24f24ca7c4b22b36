"""Rank-local ops: the kernel wrappers (``segment`` for the sorted-id kernels,
``attention`` for flash attention, both registered in ``kernels``), their
build (``_build``) and the gather/scatter primitives with the single dispatch
points (``local``)."""
