"""Process groups, the (dp, ip) mesh and its collectives (port of
kasa_tpu/parallel/dist.py).

kasa_tpu's mesh is one controller over the devices one process sees.
Here it is one process per device, the PyTorch idiom: the mesh spans the
ranks of a torch.distributed process group, one device per rank, laid
out as a DeviceMesh with dims ("dp", "ip") and "ip" innermost (rank =
dp_index * ip + ip_index), so an index shard's collectives stay among
neighbouring ranks.  KASA_MESH_DP and KASA_MESH_IP force a shape, as in
kasa_tpu; parallel/launch.py starts N ranks of one host from Python.

Backends: ranks on distinct cards talk over NCCL; ranks on the CPU, and
ranks that share one card (LOCAL_WORLD_SIZE above the cards the process
sees: NCCL refuses two ranks on one device), over gloo.  Gloo takes the
CUDA tensors of every collective here, all_gather_into_tensor included
(chip_smoke.py's mesh phase probes it: "ok" with PyTorch 2.11 and CUDA
12.8 on an H100), so no collective stages its tensors on the host by
hand.

    torchrun --nproc-per-node N -m kasa_tpu_torch identify ...
    torchrun --nproc-per-node N -m kasa_tpu_torch identify ... --device cpu
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Rank 0 alone parses to output: it decodes, recomputes flagged
    reads on the host and writes every file."""
    return rank() == 0


class NotWriter(Exception):
    """Raised by writer_only on a rank other than 0: rank 0 runs the rest
    of the run alone, and cli.main ends this rank with exit code 0."""


def writer_only() -> None:
    """The rule of a multi-process run: every rank takes part in the
    turbo mesh, and only there.  Called where a run leaves the mesh (a
    mode without one, another route, the per-batch engines); raises
    NotWriter on a rank other than 0."""
    if world_size() > 1 and not is_writer():
        raise NotWriter


def backend_for(device=None) -> str:
    """gloo for the CPU and for ranks that share a card, else NCCL."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    return "gloo" if local_world > torch.cuda.device_count() else "nccl"


def init_distributed(device=None) -> bool:
    """Join the process group described by torchrun's env contract
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR /
    MASTER_PORT), with KASA_DIST_INIT for the init method where it is
    set (a file:// path: parallel/launch.py).  A CUDA rank's current device becomes
    cuda:(LOCAL_RANK mod the cards it sees).  Returns True when the run
    is multi-process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    init_method = os.environ.get("KASA_DIST_INIT")
    if "WORLD_SIZE" not in os.environ and init_method is None:
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rk = int(os.environ.get("RANK", "0"))
    backend = backend_for(device)
    if torch.device("cuda" if device is None else device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank without a CUDA device; pass "
                               "--device cpu to run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", str(rk)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rk)
    return world > 1


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class IdentifyMesh:
    """This rank's place in the (dp, ip) mesh and the groups along each
    dim (DeviceMesh.get_group)."""
    device_mesh: object
    dp: int
    ip: int
    rank: int
    backend: str
    ip_group: object
    dp_group: object

    @property
    def dp_index(self) -> int:
        return self.rank // self.ip

    @property
    def ip_index(self) -> int:
        return self.rank % self.ip

    def describe(self) -> str:
        return f"dp={self.dp} x ip={self.ip} over {self.dp * self.ip} " \
               f"ranks, {self.backend}"


def make_identify_mesh(ip: int | None = None,
                       dp: int | None = None) -> IdentifyMesh:
    """The (dp, ip) mesh over every rank of the process group (kasa_tpu
    dist.py:48): ip defaults to the world, dp to world // ip, and
    dp * ip must equal the world.  Across hosts (LOCAL_WORLD_SIZE below
    the world) ip must divide the ranks of a host, so an index shard's
    collectives stay inside it."""
    from torch.distributed.device_mesh import init_device_mesh
    world = world_size()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if ip is None:
        ip = world if dp is None else max(world // dp, 1)
    if dp is None:
        dp = world // ip
    if dp * ip != world:
        raise ValueError(f"mesh {dp}x{ip} != {world} devices")
    if local_world < world and (ip > local_world or local_world % ip):
        raise ValueError(
            "index-parallel axis must divide the per-host rank count so "
            "the index-shard collectives stay inside a host")
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    # the mesh's device type names the backend of its groups: a gloo
    # world is a "cpu" mesh even when its ranks hold CUDA tensors
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", (dp, ip),
                          mesh_dim_names=("dp", "ip"))
    return IdentifyMesh(dm, dp, ip, rank(), backend, dm.get_group("ip"),
                        dm.get_group("dp"))


# ---------------------------------------------------------------------------
# the collectives of the mesh modules; a group of one rank is a no-op

def _size(group) -> int:
    return dist.get_world_size(group)


def or_over(group, flags: torch.Tensor) -> torch.Tensor:
    """Element-wise OR of a bool flag vector over the group (all_reduce
    MAX of its uint8 copy) -> bool."""
    if _size(group) == 1:
        return flags
    t = flags.to(torch.uint8)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t > 0


def sum_over(group, t: torch.Tensor) -> torch.Tensor:
    """In-place all_reduce SUM over the group; returns t."""
    if _size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


# all_gather_into_tensor, under the name newer PyTorch gives it
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def gather_over(group, t: torch.Tensor) -> torch.Tensor:
    """(group size, *t.shape): every rank's t (at least 1-d) in
    group-rank order."""
    n = _size(group)
    if n == 1:
        return t.unsqueeze(0)
    t = t.contiguous()
    # the output is the inputs concatenated along dim 0
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather(out, t, group=group)
    return out.view(n, *t.shape)
