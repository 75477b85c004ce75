"""The card's constants and the production meshes, after the JAX
package's `repro/launch/mesh.py`, whose constants are a TPU v5e's. These
are the NVIDIA H100's, and none of the TPU's is carried over.

Every figure is a datasheet peak of the "NVIDIA H100 80GB HBM3, 700 W"
card (SXM5), dense (no 2:4 sparsity): what the roofline of a step
(`launch/dryrun.py`) and the bound of a kernel (`chip_smoke.py`) divide
by. `H100_PEAKS` also holds the PCIe and NVL cards' rows, which
`peaks_for` picks by the card's name, so the dry run and the smoke run
read one table.

Collectives: a card's NVLink 4 moves 450 GB/s a direction (18 links of
25 GB/s) to any card of its 8-card node through the NVSwitch;
`ICI_BW_PER_LINK` stands for it where the JAX roofline divides by one
ICI link. A group of more than `NODE_CARDS` ranks spans nodes, and its
ring runs at the rate of the node's network, `NODE_NET_BW_PER_CARD`: one
400 Gb/s (NDR InfiniBand) adapter a card, the node's and not the card's.

A production mesh is JAX's (16, 16) ("data", "model") or (2, 16, 16)
("pod", "data", "model"), so a port record pairs with the JAX record of
the same cell; the dry run sees it from one rank over a `DryComm`
(`parallel/comm.py`), which counts each collective and moves nothing.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.mesh import make_test_mesh as _make_test_mesh
from repro_torch.parallel.sharding import MeshAxes

#: datasheet peaks of each H100 card: HBM bytes/s and dense FLOP/s by
#: dtype (SXM5 80GB HBM3 at 700 W; PCIe 80GB at 350 W; NVL 94GB at 400 W)
H100_PEAKS: Dict[str, Dict[str, float]] = {
    "sxm": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
    "pcie": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12},
    "nvl": {"bytes": 3.9e12, "bfloat16": 835e12, "float32": 60e12},
}

#: NVIDIA H100 80GB HBM3, 700 W (SXM5): dense bf16 tensor-core FLOP/s
PEAK_FLOPS_BF16 = H100_PEAKS["sxm"]["bfloat16"]
#: NVIDIA H100 80GB HBM3, 700 W (SXM5): f32 FLOP/s without tensor cores
PEAK_FLOPS_F32 = H100_PEAKS["sxm"]["float32"]
#: NVIDIA H100 80GB HBM3, 700 W (SXM5): HBM3 bytes/s
HBM_BW = H100_PEAKS["sxm"]["bytes"]
#: NVIDIA H100 80GB HBM3, 700 W (SXM5): NVLink 4 bytes/s a direction
NVLINK_BW = 450e9
ICI_BW_PER_LINK = NVLINK_BW
#: cards an NVLink domain (one node) holds
NODE_CARDS = 8
#: the node's network a card, bytes/s a direction: one 400 Gb/s
#: InfiniBand NDR adapter per card (a node's rate, not the card's)
NODE_NET_BW_PER_CARD = 50e9


def peaks_for(name: str) -> Dict[str, float]:
    """The `H100_PEAKS` row of a card from its name
    (`torch.cuda.get_device_name`)."""
    n = name.lower()
    return H100_PEAKS["pcie" if "pcie" in n else "nvl" if "nvl" in n
                      else "sxm"]


def link_bw(group_size: int) -> float:
    """Bytes/s a direction of a ring over `group_size` ranks: NVLink
    inside a node, the node's network when the group spans nodes."""
    return NVLINK_BW if group_size <= NODE_CARDS else NODE_NET_BW_PER_CARD


def collective_seconds(wire_by_group_size: Dict[int, float]) -> float:
    """Seconds the wire bytes per device take, each group size at its
    link's rate."""
    return sum(float(b) / link_bw(int(n))
               for n, b in wire_by_group_size.items())


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """JAX's production mesh seen from `rank`, over a `DryComm`: the dry
    run traces one rank's step on the meta device."""
    from repro_torch.parallel.comm import DryComm
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = Mesh(shape, axes, rank=rank)
    DryComm(mesh)
    return mesh


def mesh_axes(mesh) -> MeshAxes:
    """Logical roles for a production mesh: every non-"model" axis is a
    dp / fsdp axis; "model" is the TP / EP axis."""
    return MeshAxes(dp=tuple(a for a in mesh.axis_names if a != "model"),
                    tp="model")


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"), *,
                   rank: int = 0, dry: bool = False) -> Mesh:
    """A small mesh (`parallel/mesh.py::make_test_mesh`), with a
    `DryComm` when `dry`."""
    mesh = _make_test_mesh(shape, axes, rank=rank)
    if dry:
        from repro_torch.parallel.comm import DryComm
        DryComm(mesh)
    return mesh


__all__ = ["H100_PEAKS", "HBM_BW", "ICI_BW_PER_LINK", "NODE_CARDS",
           "NODE_NET_BW_PER_CARD", "NVLINK_BW", "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_F32", "collective_seconds", "link_bw",
           "make_production_mesh", "make_test_mesh", "mesh_axes",
           "peaks_for"]
