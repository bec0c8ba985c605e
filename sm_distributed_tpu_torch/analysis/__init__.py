"""Analysis tools of the port: ``lockorder`` (the runtime lock-order
detector, a copy of the JAX package's, scoped to this package),
``numerics`` (the numerics contracts each scoring module declares, and the
ULP helpers ``drivers/ulp_sentinel.py`` measures with) and ``profiling``
(on-demand device profiles through ``torch.profiler``, behind ``GET
/debug/profile``).  The JAX package's static lint (``smlint``) keys on its
own tree and has no counterpart here."""

from . import lockorder  # noqa: F401
