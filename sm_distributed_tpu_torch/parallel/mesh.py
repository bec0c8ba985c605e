"""The ("pixels", "formulas") device mesh of the port.

Port of ``sm_distributed_tpu/parallel/mesh.py``.  The JAX package's mesh is
a ``jax.sharding.Mesh`` that one SPMD program spans; here it is a 2-D grid
of ``torch.device``s that one controller (the search's own thread) drives,
cell by cell (``parallel/sharded.py``):

- ``"pixels"`` shards the dataset's pixel dimension (each pixel shard holds
  the peaks of a contiguous run of image rows);
- ``"formulas"`` shards each formula batch.

Axis sizes come from ``SMConfig.parallel`` (``pixels_axis``,
``formulas_axis``), where ``-1`` takes every device left over after the
explicit axes, as in the JAX package.  The devices come from a device-pool
lease (:func:`lease_devices`), from the config (:func:`config_devices`) or
from the caller.  A mesh built from a lease or from the config never
repeats a device: on ``device: cuda`` it takes distinct visible cards (and
with the default axes one card, where the JAX package's default mesh
spans every device); on ``device: cpu`` the CPU stands in for as many
devices as the explicit axes ask, the counterpart of the JAX tests'
virtual CPU devices.  Only a caller
that passes the device list may repeat a device (the tests, and
``chip_smoke.py`` on a one-card machine).

**A mesh spanning processes.**  Under the launch contract
(``parallel/distributed.py``: ``SM_COORDINATOR``, ``SM_NUM_PROCESSES``,
``SM_PROCESS_ID``) the pod's chips are ordered host-major, ranks in order
and each rank's chips in order (:func:`global_device_order`).  A mesh over
that order holds this process's chips as ``torch.device``s and every other
process's as :class:`RemoteChip` placeholders; each process drives only
its own cells (:meth:`Mesh.local`).  Such a mesh comes from a ``cuda``
lease with another process's chips, from config axes asking for more
cards than this process has, or from an explicit device list shorter than
the axes ask (this process's part; every process passes its own).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.logger import logger

PIXELS_AXIS = "pixels"
FORMULAS_AXIS = "formulas"


def resolve_axis_sizes(n_devices: int, cfg) -> tuple[int, int]:
    """(pixels, formulas) axis sizes using exactly their product <=
    n_devices.

    ``-1`` entries absorb all devices left over after the explicit axes.
    Both -1: all devices go to the pixel axis (the dominant data axis)."""
    pix, form = cfg.pixels_axis, cfg.formulas_axis
    if pix < -1 or form < -1 or pix == 0 or form == 0:
        raise ValueError(
            f"mesh axis sizes must be -1 or positive, got pixels_axis={pix}, "
            f"formulas_axis={form}")
    if pix == -1 and form == -1:
        pix, form = n_devices, 1
    elif pix == -1:
        if n_devices % form:
            raise ValueError(
                f"formulas_axis={form} does not divide {n_devices} devices")
        pix = n_devices // form
    elif form == -1:
        if n_devices % pix:
            raise ValueError(
                f"pixels_axis={pix} does not divide {n_devices} devices")
        form = n_devices // pix
    if pix * form > n_devices:
        raise ValueError(
            f"mesh {pix}x{form} needs {pix * form} devices, only {n_devices} "
            "available")
    return pix, form


@dataclass(frozen=True)
class RemoteChip:
    """A chip of another process in a mesh that spans processes: that
    process's index and the chip's id, its place in the pod's host-major
    order, so :func:`global_device_order` sorts it as the JAX package
    sorts ``jax.Device``s.  The process that owns it drives its cells."""
    process_index: int
    id: int

    def __str__(self) -> str:
        return f"process{self.process_index}:chip{self.id}"


def pod_devices(local: list, counts) -> list:
    """The pod's host-major chip order: process r's ``counts[r]`` chips in
    turn, this process's as ``local`` (its devices, in order), every other
    process's as a :class:`RemoteChip`."""
    from .distributed import world

    rank = world()[0]
    if counts[rank] != len(local):
        raise ValueError(f"process {rank} holds {len(local)} chips, the pod "
                         f"says {counts[rank]}")
    out: list = []
    for r, n in enumerate(counts):
        out += (list(local) if r == rank else
                [RemoteChip(r, len(out) + i) for i in range(n)])
    return out


class Mesh:
    """A (pixels, formulas) grid of devices.  ``devices[s, f]`` is the
    device of cell (s, f), a ``torch.device`` or, in a mesh spanning
    processes, another process's :class:`RemoteChip`; ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    axis_names = (PIXELS_AXIS, FORMULAS_AXIS)

    def __init__(self, devices):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for s, row in enumerate(devices):
            if len(row) != grid.shape[1]:
                raise ValueError("mesh rows must have one length")
            for f, d in enumerate(row):
                grid[s, f] = d
        self.devices = grid

    @property
    def shape(self) -> dict[str, int]:
        return {PIXELS_AXIS: self.devices.shape[0],
                FORMULAS_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct(self) -> list:
        """The mesh's devices, each once, in row-major order."""
        return list(dict.fromkeys(self.devices.flat))

    def local(self) -> list[tuple[int, int]]:
        """The cells (s, f) this process drives, formula shard-major."""
        n_pix, n_form = self.devices.shape
        return [(s, f) for f in range(n_form) for s in range(n_pix)
                if not isinstance(self.devices[s, f], RemoteChip)]

    def owner(self, s: int, f: int) -> int:
        """The process that drives cell (s, f)."""
        d = self.devices[s, f]
        if isinstance(d, RemoteChip):
            return d.process_index
        from .distributed import world

        return world()[0]

    def spans_processes(self) -> bool:
        return any(isinstance(d, RemoteChip) for d in self.devices.flat)


def make_mesh(cfg, devices=None, hosts: int = 1,
              device: str = "cuda") -> Mesh:
    """The ("pixels", "formulas") mesh from ``cfg`` (a ``ParallelConfig``)
    over ``devices`` (default: :func:`config_devices` of ``device``).

    ``hosts`` declares the host x chip topology the device list came from.
    The device order is host-major, so with ``hosts`` dividing the pixels
    axis each host's chips form a contiguous block of pixel shards; a
    topology the grid cannot honour is logged and ignored, as in the JAX
    package."""
    devices = list(devices if devices is not None
                   else config_devices(device, cfg))
    pix, form = resolve_axis_sizes(len(devices), cfg)
    if hosts > 1:
        if pix % hosts:
            logger.warning(
                "make_mesh: %d hosts does not divide the %d-shard pixels "
                "axis; host blocks will straddle mesh rows", hosts, pix)
        else:
            logger.info("make_mesh: %dx%d mesh over %d host(s) "
                        "(%d pixel shard(s) per host)",
                        pix, form, hosts, pix // hosts)
    flat = devices[:pix * form]
    return Mesh([flat[s * form:(s + 1) * form] for s in range(pix)])


def axes_ask(cfg) -> int:
    """The devices the config's axes ask for (a ``-1`` axis asks for
    one)."""
    return max(1, cfg.pixels_axis) * max(1, cfg.formulas_axis)


def config_devices(device: str, cfg) -> list:
    """The devices a mesh built from the config spans.  The axes ask for
    ``axes_ask(cfg)`` devices.  ``cpu``: the CPU, that many times.
    ``cuda``: one card (the current one) when they ask for one, so the
    shipped defaults score on one card as before; every visible card when
    they ask for more (a ``-1`` axis then absorbs the cards left over, as in
    the JAX package), raising without one: nothing falls back to the CPU;
    in a pod whose group is up, the pod's global card order when they ask
    for more than this process's cards.  ``cuda:i``: that card alone."""
    dev = torch.device(device)
    n = axes_ask(cfg)
    if dev.type == "cpu":
        return [dev] * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if dev.index is not None or n == 1:
        return [dev]
    if not torch.cuda.is_available():
        from ..models.msm_torch import resolve_device

        resolve_device(dev)           # raises, naming the missing card
    local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    from .distributed import pod

    facts = pod()
    if facts is not None and n > len(local):
        return pod_devices(local, [len(c) for c in facts.cards])
    return local


def host_topology(device_indices, chips_per_host) -> dict[int, tuple]:
    """Group a lease's chip indices by host failure domain:
    ``{host: (chip, ...)}``.  ``chips_per_host`` is an int (equal hosts of
    that many chips) or explicit per-host ``(lo, hi)`` ranges
    (``service/health.py::split_host_ranges``)."""
    ranges = None
    if not isinstance(chips_per_host, int):
        ranges = [(int(lo), int(hi)) for lo, hi in chips_per_host]
    out: dict[int, list[int]] = {}
    for i in device_indices or ():
        i = int(i)
        if ranges is None:
            out.setdefault(i // max(1, int(chips_per_host)), []).append(i)
            continue
        for h, (lo, hi) in enumerate(ranges):
            if lo <= i < hi:
                out.setdefault(h, []).append(i)
                break
        else:
            out.setdefault(len(ranges) - 1 if ranges else 0, []).append(i)
    return {h: tuple(sorted(v)) for h, v in sorted(out.items())}


def global_device_order(devices) -> list:
    """The pod-wide host-major device list: ``devices`` sorted by
    ``(process_index, id)`` (objects without them count as process 0, id
    0), so the pool's chip index -> device map does not depend on the
    enumeration order."""
    return sorted(devices, key=lambda d: (int(getattr(d, "process_index", 0)),
                                          int(getattr(d, "id", 0))))


def lease_devices(device_indices, devices=None,
                  device: str = "cuda") -> list | None:
    """Map a device-pool lease's chip indices to the devices of a mesh.

    ``None`` -> ``None`` (the caller meshes over the config's devices).
    ``devices`` is the pool's chip order (default: this process's visible
    cards on ``cuda``, the pod's cards in a multi-process runtime; on
    ``cpu`` every chip of the simulated pool is this process's CPU).
    Indices beyond it are dropped with a warning, and an empty result falls
    back to ``None``, as in the JAX package: the work goes to the chips
    that exist, never to the host.  In a multi-process runtime the pool
    indexes the global host-major order (:func:`global_device_order` of
    chips carrying ``process_index`` and ``id``): this process's chips map
    to its cards, in its order, and every other process's chip to a
    :class:`RemoteChip`, which a mesh spanning processes holds."""
    if device_indices is None:
        return None
    indices = [int(i) for i in device_indices]
    from .distributed import pod, world

    rank, size = world()
    dev = torch.device(device)
    multi = size > 1 and dev.type != "cpu"
    if devices is None:
        if dev.type == "cpu":
            devices = [dev] * (max(indices, default=0) + 1)
        elif multi:
            counts = [len(c) for c in pod().cards]
            devices = [RemoteChip(r, sum(counts[:r]) + i)
                       for r, n in enumerate(counts) for i in range(n)]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    if multi:
        order = global_device_order(devices)
        mine = [d for d in order if int(d.process_index) == rank]
        devices = [torch.device(dev.type, mine.index(d))
                   if int(d.process_index) == rank
                   else RemoteChip(int(d.process_index), int(d.id))
                   for d in order]
    picked = [devices[i] for i in indices if 0 <= i < len(devices)]
    if len(picked) < len(indices):
        logger.warning(
            "device lease %s exceeds the %d visible devices; %s",
            tuple(indices), len(devices),
            f"using {len(picked)} chip(s)" if picked
            else "falling back to the config mesh")
    return picked or None
