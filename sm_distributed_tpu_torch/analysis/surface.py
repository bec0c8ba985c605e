"""KERNEL_SURFACE: the declared kernel build surface of the port.

The JAX package declares its XLA compile surface (every ``jax.jit`` site
and its shape-bucket policy) in ``COMPILE_SURFACE``.  Eager torch compiles
nothing per shape: what the port builds is its hand-written CUDA
libraries, one ``nvcc`` run each (``kernels/_build.py``), and what a
primed replica must have built before its first job is the set of
libraries its specs launch (``service/primer.spec_kernels``).  So the
port's surface is the kernel build surface:

- every module that launches a hand-written kernel declares a module-level
  ``KERNEL_SURFACE = kernel_surface(__name__, {...})`` mapping each
  **launch site** (the function that calls ``_build.ready``) to a
  **policy string**::

      "library=<csrc name>; shapes=<what bounds the launch's shapes>"

  e.g. ``"library=moments; shapes=K <= 8 rows an ion a launch, the
  cluster plan of ops/moments.moments_plan"``;

- the ``kernel-build-surface`` smlint rule (``rules.py``) cross-checks the
  declarations against the code: every library a call of ``_build.load``
  / ``ready`` / ``prime`` / ``build_all`` names is in ``_build.KERNELS``
  and has its ``csrc/<name>.cu``; every launch site is declared with the
  library it readies; no entry is dead; and every declared library is one
  that ``service/primer.spec_kernels`` can return, or a primed replica
  would still pay ``nvcc`` on its first job;

- the runtime half is the build census (``kernels/_build.census``,
  ``drivers/compile_census.py``).

The registry is import-time write-once state behind one leaf lock, as the
JAX package's.
"""

from __future__ import annotations

import threading

# tokens every policy string must carry (the kernel-build-surface rule
# checks the same grammar statically; keep them in lockstep)
POLICY_TOKENS = ("library=", "shapes=")


class _SurfaceRegistry:
    """Process-global {module: {site: policy}} map."""

    _GUARDED_BY = {"_surfaces": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._surfaces: dict[str, dict[str, str]] = {}

    def declare(self, module: str, entries: dict[str, str]) -> None:
        with self._lock:
            self._surfaces[module] = dict(entries)

    def registered(self) -> dict[str, dict[str, str]]:
        with self._lock:
            return {m: dict(e) for m, e in self._surfaces.items()}


_registry = _SurfaceRegistry()


def policy_library(policy: str) -> str:
    """The ``library=`` clause of a policy string ("" when absent)."""
    for part in policy.split(";"):
        key, _, value = part.strip().partition("=")
        if key.strip() == "library":
            return value.strip()
    return ""


def kernel_surface(module: str, entries: dict[str, str]) -> dict[str, str]:
    """Declare ``module``'s kernel launch sites and return ``entries`` (the
    declaration doubles as the module-level ``KERNEL_SURFACE`` constant).
    A malformed policy raises at import time."""
    for site, policy in entries.items():
        if not isinstance(policy, str) or not all(
                t in policy for t in POLICY_TOKENS) or \
                not policy_library(policy):
            raise ValueError(
                f"kernel_surface({module!r}): entry {site!r} must be a "
                f"policy string carrying {' and '.join(POLICY_TOKENS)} "
                f"clauses, got {policy!r}")
    _registry.declare(module, entries)
    return dict(entries)


def registered() -> dict[str, dict[str, str]]:
    """{module name: {site: policy}} of every imported declaration."""
    return _registry.registered()
