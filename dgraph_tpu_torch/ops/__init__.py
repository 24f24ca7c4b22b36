"""Rank-local ops: the kernel wrappers (``segment``), their build (``_build``)
and the gather/scatter primitives with the single dispatch points (``local``)."""
