"""The engine mesh of the sharded serving plane.

Counterpart of `repro/launch/mesh.py` (`make_production_mesh`,
`make_engine_mesh`, `make_test_mesh`).  The reference builds a
`jax.sharding.Mesh` and runs one jitted program over it from one
process; the port is single-controller in the same way: an
`EngineMesh` is a row-major list of torch devices with named axes,
and one process drives every device of it
(engines are worker threads, the EP all-to-all is copies between the
shards' devices, `repro_torch.models.moe_ep`).  A device may repeat, so
four logical shards can sit on one card (`["cuda:0"] * 4`) or on the CPU
(`["cpu"] * 4`); on four cards they sit on `cuda:0..3` and the exchange
is peer copies.  The same code runs in all three places.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


class EngineMesh:
    """Devices laid out row-major over named axes, like
    `jax.sharding.Mesh`: `devices[i]` is the device of flat index i,
    `shape` maps each axis name to its size, `axis_names` keeps their
    order (slowest first)."""

    def __init__(self, devices: Sequence, shape: Sequence[int],
                 axis_names: Sequence[str]):
        devs = [_indexed(d) for d in devices]
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        if math.prod(shape) != len(devs):
            raise ValueError(f"{len(devs)} devices for a mesh of shape "
                             f"{tuple(shape)}")
        self.devices: List[torch.device] = devs
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The first device: the one the host-side tensors (tokens, block
        tables, logits) and, without model ranks, the dense prefill
        live on (under TP the dense prefill runs on DP 0's ranks)."""
        return self.devices[0]

    @property
    def distinct(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def coords(self, i: int) -> Dict[str, int]:
        """The axis coordinates of flat device index i."""
        out = {}
        for a in reversed(self.axis_names):
            out[a] = i % self.shape[a]
            i //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def index(self, coords: Dict[str, int], axes: Sequence[str]) -> int:
        """Row-major rank of `coords` over `axes` (in the order given)."""
        r = 0
        for a in axes:
            r = r * self.shape[a] + coords[a]
        return r

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"EngineMesh({shape}; {[str(d) for d in self.devices]})"


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" is the current card, as a tensor
    placed there reports it (so a mesh device equals its tensors')."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _cuda_devices(need: int, what: str) -> List[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(
            f"{what} needs {need} CUDA devices, have {have} — pass "
            f"`devices` (e.g. [\"cuda:0\"] * {need} for logical shards on "
            f"one card, or [\"cpu\"] * {need})")
    return [torch.device("cuda", i) for i in range(need)]


def make_production_mesh(*, multi_pod: bool = False) -> EngineMesh:
    """The dry-run's logical mesh: 16 × 16 ("data", "model"; 256 cards,
    32 hosts of 8) or 2 × 16 × 16 ("pod", "data", "model"; 512 cards, 64
    hosts of 8), over `meta` devices.  Counterpart of the reference's
    `make_production_mesh`; it needs no device: the dry-run only reads
    each rank's shapes off it (`distributed.sharding`'s specs)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return EngineMesh(["meta"] * math.prod(shape), shape, axes)


def make_engine_mesh(data: int, model: int = 1,
                     devices: Optional[Sequence] = None) -> EngineMesh:
    """Mesh of the SHARDED real serving plane: one data-axis rank per
    decode DP unit (the merged paged cache's slots and pool blocks shard
    over "data"), `model` ranks of tensor parallelism inside each DP
    (row-major: device d·model + m is DP d's model rank m).
    `devices=None` takes the first `data·model` CUDA devices and raises
    RuntimeError when there are fewer (never fewer shards, never the
    CPU); an explicit list may repeat a device."""
    if data < 1 or model < 1:
        raise ValueError(f"a ({data},{model}) data×model mesh")
    need = data * model
    if devices is None:
        devices = _cuda_devices(need, f"a ({data},{model}) data×model mesh")
    if len(devices) != need:
        raise ValueError(f"{len(devices)} devices for a ({data},{model}) "
                         f"data×model mesh")
    return EngineMesh(devices, (data, model), ("data", "model"))


def make_test_mesh(data: int = 2, model: int = 2,
                   devices: Optional[Sequence] = None) -> EngineMesh:
    """A data×model mesh for tests (model > 1 allowed: the EP layer runs
    on any mesh), on `devices` (default: that many logical CPU shards)."""
    if devices is None:
        devices = ["cpu"] * (data * model)
    return EngineMesh(devices, (data, model), ("data", "model"))


def parse_mesh_devices(spec: str) -> List[str]:
    """A device list from the command line: comma-separated devices, each
    optionally repeated with `xN` (`cuda:0x4`, `cpu x4`, `cuda:0,cuda:1`)."""
    out: List[str] = []
    for part in spec.replace(" ", "").split(","):
        if not part:
            continue
        dev, _, n = part.partition("x")
        out.extend([dev] * (int(n) if n else 1))
    return out
