"""Multi-process execution: chains x mutations over a mesh of ranks
(counterpart of bnpc_tpu/parallel/sharded.py).

bnpc_tpu runs one controller over a device mesh with ``shard_map``; the
port runs one process per rank under torch.distributed. Rank
``r = c * M + mu`` of a ``C x M`` mesh holds chain shard ``c`` and mutation
shard ``mu``:

  * **Chain sharding** — chain shard c runs its n / C chains one after
    another or, under ``chain_exec="vmap"``, as one batch, exactly as the
    one-process runner runs chains; chains never talk while sampling.
  * **Mutation sharding** — the ranks of one chain shard form its mutation
    group. Each holds m_pad / M columns of the data planes and the
    parameter rows; every sum over mutations is all-reduced over the group
    (``MutAxis``), so every rank of the group makes the same decisions and
    launches the same kernels on the same bits.

Every rank creates every group in the same order. Host-side traffic (trace
rows, checkpoints, the run modes' stop decisions) goes over ``host_group``,
a gloo group over the whole mesh: rank 0 gathers every rank's trace rows
once a block, checks that the replicated fields of each mutation group
agree bit for bit, and writes the results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import PackedData, local_cols, local_mut_mask
from bnpc_tpu_torch.mcmc import _make_block, resolve_trace_k
from bnpc_tpu_torch.parallel.axis import MutAxis


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``chains x muts`` mesh of ranks."""

    chains: int        # C: chain shards
    muts: int          # M: mutation shards
    rank: int          # c * M + mu
    mut_group: object  # ProcessGroup of this chain shard's M ranks (M > 1)
    host_group: object  # gloo group over the whole mesh (host objects)

    @property
    def chain_index(self) -> int:
        return self.rank // self.muts

    @property
    def mut_index(self) -> int:
        return self.rank % self.muts

    @property
    def size(self) -> int:
        return self.chains * self.muts

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def make_mesh(n_chain_shards: int, n_mut_shards: int = 1) -> Mesh:
    """The mesh over the initialized process group, whose world size must
    be n_chain_shards * n_mut_shards."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = n_chain_shards * n_mut_shards
    if world < need:
        raise ValueError(
            f"need {need} devices for a {n_chain_shards}x{n_mut_shards} mesh,"
            f" have {world}"
        )
    if world > need:
        raise ValueError(f"a {n_chain_shards}x{n_mut_shards} mesh uses {need}"
                         f" ranks; this run has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    mut_group = None
    if n_mut_shards > 1:
        for c in range(n_chain_shards):
            g = dist.new_group([c * n_mut_shards + mu
                                for mu in range(n_mut_shards)])
            if rank // n_mut_shards == c:
                mut_group = g
    host_group = None
    if dist.is_initialized():
        host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                      else dist.new_group(backend="gloo"))
    return Mesh(n_chain_shards, n_mut_shards, rank, mut_group, host_group)


def mut_axis(mesh: Mesh, m_pad: int, m_real: int, device) -> MutAxis:
    """This rank's MutAxis: unsharded for a size-1 mutation axis; the mask
    only where m was padded."""
    if mesh.muts == 1:
        return MutAxis()
    mask = (local_mut_mask(m_pad, m_real, mesh.mut_index, mesh.muts, device)
            if m_pad != m_real else None)
    return MutAxis(mesh.mut_group, mesh.mut_index, mesh.muts, mask)


def make_sharded_block(mesh: Mesh, cfg: ModelConfig, mcmc_cfg: MCMCConfig,
                       data: PackedData, chain_exec: str = "auto",
                       gibbs_impl: str = "auto"):
    """mcmc.py::_make_block's block over this rank's local chains and
    mutation axis: (states, draws, n_steps, keep=None) -> (states, rows,
    next_draws), the chains one after another or, under
    ``chain_exec="vmap"`` (bnpc_tpu's sharded.py:124-185), as one batch on
    a ChainAxis over that axis; "auto" as resolve_chain_exec decides for a
    mesh.

    Under a batch every rank of a mutation group issues the same
    all-reduces in the same order: each batched sum is one all-reduce of
    the whole batch, and each birth's column one all-reduce, in chain
    order, decided from all-reduced values (models/gibbs.py).

    `data` is the whole matrix padded with data.pad_muts to the mesh's
    mutation-shard count; `states` hold this rank's columns of the padded
    parameter rows. Rows come back as host arrays [chains, steps, ...] with
    this rank's columns of the params trace; ``gather_rows`` assembles
    them. With one mutation shard the block runs the unsharded step
    (bnpc_tpu's sharded.py:157-168). The step, its axis, its local data and
    its config are attributes of the block."""
    m_pad = data.n_muts
    cfg_pad = (cfg if m_pad == cfg.n_muts
               else dataclasses.replace(cfg, n_muts=m_pad))
    local = (local_cols(data, mesh.mut_index, mesh.muts) if mesh.muts > 1
             else data)
    return _make_block(cfg_pad, mcmc_cfg, local,
                       resolve_trace_k(cfg, mcmc_cfg),
                       mut_axis(mesh, m_pad, cfg.n_muts, data.xm.device),
                       gibbs_impl, chain_exec, mesh)


# ---------------------------------------------------------------------------
# Host-side collectives (over the mesh's gloo host group)
# ---------------------------------------------------------------------------


def broadcast(mesh: Mesh, obj):
    """Rank 0's `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


def gather(mesh: Mesh, obj) -> list | None:
    """Every rank's `obj`, in rank order, on rank 0; None elsewhere."""
    out = [None] * mesh.size if mesh.is_root else None
    dist.gather_object(obj, out, dst=0, group=mesh.host_group)
    return out


def scatter(mesh: Mesh, objs: list | None):
    """objs[r] on rank r (`objs` is read on rank 0 only)."""
    box = [None]
    dist.scatter_object_list(box, objs if mesh.is_root else None, src=0,
                             group=mesh.host_group)
    return box[0]


def assemble(mesh: Mesh, parts: list, m_real: int | None,
             sharded_fields=("params",), stacked_fields=()) -> dict:
    """Rank 0: per-chain dicts from every rank's (chain ids, mutation index,
    {field: [chains, ...]}) part, as {field: [n_chains, ...]} in chain
    order. `sharded_fields` are concatenated over the mutation shards along
    their last axis (and cut to `m_real` columns when given),
    `stacked_fields` stacked over them ([n_chains, M, ...]); every other
    field must be equal bit for bit on every rank of the group."""
    by_chain: dict[int, dict[int, dict]] = {}
    for ids, mu, fields in parts:
        for j, g in enumerate(ids):
            by_chain.setdefault(g, {})[mu] = {f: v[j]
                                              for f, v in fields.items()}
    out = {}
    for g in sorted(by_chain):
        shards = [by_chain[g][mu] for mu in range(mesh.muts)]
        for f, v in shards[0].items():
            if f in sharded_fields:
                v = np.concatenate([s[f] for s in shards], axis=-1)
                if m_real is not None:
                    v = v[..., :m_real]
            elif f in stacked_fields:
                v = np.stack([s[f] for s in shards])
            else:
                for mu, s in enumerate(shards[1:], 1):
                    if not np.array_equal(s[f], v):
                        raise RuntimeError(
                            f"chain {g}: the replicated {f!r} differs "
                            f"between mutation shards 0 and {mu}")
            out.setdefault(f, []).append(v)
    return {f: np.stack(v) for f, v in out.items()}


def gather_rows(mesh: Mesh, rows: dict, chains, m_real: int) -> dict | None:
    """Rank 0: the trace rows of every chain ({field: [n_chains, steps,
    ...]}, params cut to the real m); None elsewhere. Each rank sends its
    local chains' rows once; rank 0 holds the replicated fields of each
    mutation group against each other."""
    parts = gather(mesh, (list(chains), mesh.mut_index, rows))
    if not mesh.is_root:
        return None
    return assemble(mesh, parts, m_real)
