"""Analysis tools of the port: ``lockorder`` (the runtime lock-order
detector, a copy of the JAX package's, scoped to this package),
``numerics`` (the numerics contracts each scoring module declares, and the
ULP helpers ``drivers/ulp_sentinel.py`` measures with), ``profiling``
(on-demand device profiles through ``torch.profiler``, behind ``GET
/debug/profile``), and the port's smlint: ``core`` and ``dataflow`` (the
JAX package's lint framework and taint engine, copied, the package root a
parameter), ``rules`` (its seven service rules, and its six hot-path rules
retargeted to torch and the kernel builds), ``surface`` (the declared
kernel build surface) and ``synccensus`` (the host-sync rule's runtime
half on the card), behind ``drivers/smlint.py``."""

from . import lockorder  # noqa: F401
