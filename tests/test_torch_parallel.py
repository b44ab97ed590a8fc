"""The port's parallel/ against bnpc_tpu's sharded execution, in gloo CPU
processes.

Ranks are spawned with torch.multiprocessing from functions of this module
and join a localhost process group (gloo). bnpc_tpu's reference runs in
this process on the virtual CPU devices of tests/conftest.py and reaches
the workers as numpy arrays; the workers replay its keys through JaxDraws.
Two worlds are spawned once, together, at the start of the module fixture:
two ranks for the 1 x 2 and 2 x 1 cases, four for the 1 x 4 and 2 x 2
ones. While they start, bnpc_tpu's two references are compiled at once,
one in this process and one in a helper process, and each is handed to the
workers as a file the moment it is ready.

bnpc_tpu's reference is its make_sharded_block over a 1 x M mesh, a block
of one step applied step after step (one compiled program a mesh). A
2 x 2 mesh runs chain c on the ranks of chain shard c with the 1 x 2
program, so chain c of the port's 2 x 2 run is held to bnpc_tpu's 1 x 2
block of chain c.

Tolerances: assignments, sizes and MH counts bit for bit; live params
rtol 1e-6 and the scalars rtol 1e-6 (tests/test_pallas.py:44-51); ML and
the log prior rtol 1e-5 (float32 sums in another order than XLA's, as in
tests/test_torch_step.py); the f16 params trace rtol 1e-3. The same bar
holds at 1 x 4 (m = 30 padded to 32) and 2 x 2.
"""

import os
import pickle
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bnpc_tpu.config import MCMCConfig as JMCMCConfig
from bnpc_tpu.data import pack_data as jpack
from bnpc_tpu.parallel import sharded as jsharded
from bnpc_tpu.state import init_state as jinit_state
from bnpc_tpu_torch import mcmc as tmcmc
from bnpc_tpu_torch.config import MCMCConfig
from bnpc_tpu_torch.convert import state_from_numpy
from bnpc_tpu_torch.data import pack_data as tpack
from bnpc_tpu_torch.data import pad_muts
from bnpc_tpu_torch.draws import TorchDraws
from bnpc_tpu_torch.parallel import multihost, sharded
from bnpc_tpu_torch.parallel.axis import MutAxis
from tests.torch_parity import JaxDraws, configs, make_problem

torch.set_num_threads(1)

N, STEPS = 24, 4
MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
             fn_sd=0.1)
MIX = dict(sm_prob=0.5, dpa_prob=0.25, error_prob=0.5, sm_steps=2)
# (m, data seed) of the 1 x 2 / 2 x 2 problem and of the padded 1 x 4 one.
M2, M4 = 12, 30
CHAIN_SEEDS = (0, 1)


def _data(m):
    return make_problem(n=N, m=m, k_clones=3, seed=m)[0]


def _leaves(tree):
    return [np.asarray(x) for x in tree]


# ---------------------------------------------------------------------------
# bnpc_tpu's reference (this process)
# ---------------------------------------------------------------------------


def _jax_reference(m, shards, seeds):
    """Per chain seed: bnpc_tpu's initial state (params padded with 0.5),
    the chain's key data, and its state and trace row after each step of
    make_sharded_block over a 1 x `shards` mesh."""
    jc, _ = configs(N, m, N, **MODEL)
    packed = jpack(_data(m))
    padded, m_pad = jsharded.pad_muts(packed, shards)
    block = jsharded.make_sharded_block(jsharded.make_mesh(1, shards), jc,
                                        JMCMCConfig(**MIX), padded)
    out = []
    for seed in seeds:
        st = jinit_state(jax.random.key(seed), jc, packed, mode="random")
        st = st._replace(params=jnp.pad(st.params, [(0, 0), (0, m_pad - m)],
                                        constant_values=0.5))
        chain_key = jax.random.key(1000 + seed)
        step_keys = jax.random.split(chain_key, STEPS + 1)[1:]
        ref = {"init": _leaves(st), "states": [], "rows": [],
               "key": np.asarray(jax.random.key_data(chain_key))}
        st = jax.tree.map(lambda x: x[None], st)
        for s in range(STEPS):
            st, rows = block(st, step_keys[None, s:s + 1])
            ref["states"].append([x[0] for x in _leaves(st)])
            ref["rows"].append({f: np.asarray(v)[0, 0]
                                for f, v in rows._asdict().items()})
        out.append(ref)
    return out


# ---------------------------------------------------------------------------
# Workers (spawned ranks)
# ---------------------------------------------------------------------------


class _Payload:
    """A worker's view of the files its parent feeds: item `name` is read
    (waiting for it) at first use."""

    def __init__(self, tmp):
        self.tmp, self.items = tmp, {"tmp": tmp}

    def __getitem__(self, name):
        if name not in self.items:
            path = os.path.join(self.tmp, f"{name}.pkl")
            deadline = time.monotonic() + 900
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no {name} from the parent")
                time.sleep(0.05)
            with open(path, "rb") as f:
                self.items[name] = pickle.load(f)
        return self.items[name]


def _jax_cpu():
    """A spawned process's JAX: the CPU, and tests/conftest.py's
    compilation cache."""
    from bnpc_tpu.utils.cache import enable_compilation_cache

    jax.config.update("jax_platforms", "cpu")
    enable_compilation_cache(None)


def _worker(rank, world, port, tmp, tasks):
    _jax_cpu()
    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    payload = _Payload(tmp)
    out = {name: globals()[name](rank, payload) for name in tasks}
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _feed_reference(path, m, shards, seeds):
    """Helper process: write _jax_reference(m, shards, seeds) to `path`."""
    _jax_cpu()
    ref = _jax_reference(m, shards, seeds)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(ref, f)
    os.replace(path + ".tmp", path)


class _World:
    """`world` ranks spawned now, running `tasks` (names of functions of
    this module) on the items fed to them."""

    def __init__(self, world, tasks, tmp):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.world, self.tmp = world, tmp
        self.ctx = mp.start_processes(_worker,
                                      args=(world, port, tmp, tasks),
                                      nprocs=world, join=False,
                                      start_method="spawn")

    def feed(self, name, obj):
        path = os.path.join(self.tmp, f"{name}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(obj, f)
        os.replace(path + ".tmp", path)

    def results(self):
        """Every rank's {task: result}; raises if a rank failed."""
        while not self.ctx.join():
            pass
        outs = []
        for r in range(self.world):
            with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs



def _port_cfgs(m):
    return configs(N, m, N, **MODEL)[1], MCMCConfig(**MIX)


def _state_np(st):
    return [x.numpy() for x in st]


def _sharded_block(mesh, m, refs, impl):
    """This rank's chain of `refs` through the port's make_sharded_block:
    (state after one step, states and rows of a STEPS-step block)."""
    tc, tm = _port_cfgs(m)
    padded, m_pad = pad_muts(tpack(_data(m), "cpu"), mesh.muts)
    block = sharded.make_sharded_block(mesh, tc, tm, padded,
                                       gibbs_impl=impl)
    ref = refs[mesh.chain_index]
    init = state_from_numpy(*ref["init"], device="cpu")
    w = m_pad // mesh.muts
    init = init._replace(params=init.params[:, mesh.mut_index * w:
                                            (mesh.mut_index + 1) * w])
    key = jax.random.wrap_key_data(ref["key"])
    # A partial block (keep) takes a whole block's keys, as bnpc_tpu's.
    (one,), _, _ = block([init], [JaxDraws(key)], STEPS, keep=1)
    (four,), rows, _ = block([init], [JaxDraws(key)], STEPS)
    return {"one": _state_np(one), "four": _state_np(four),
            "rows": {f: v[0] for f, v in rows.items()},
            "mu": mesh.mut_index, "chain": mesh.chain_index}


def task_ops(rank, payload):
    """ll_matrix and log_prior_full over a 1 x 2 mesh against their
    unsharded values (m = 11, padded to 12: rank 1 holds a padded
    column)."""
    from bnpc_tpu_torch.data import local_cols, local_mut_mask
    from bnpc_tpu_torch.ops import likelihood as lk

    mesh = sharded.make_mesh(1, 2)
    m = 11
    data = tpack(_data(m), "cpu")
    tc, _ = _port_cfgs(m)
    rng = np.random.default_rng(0)
    theta = torch.from_numpy(
        rng.uniform(1e-5, 1 - 1e-5, (5, m)).astype(np.float32))
    sizes = torch.tensor([3, 0, 7, 1, 13], dtype=torch.int32)
    alpha, fp, fn = (torch.tensor(v) for v in (4.0, 0.01, 0.2))
    c1, c0 = lk.log_prob_tables(theta, fp, fn)
    want_ll = lk.ll_matrix(data, c1, c0)
    want_lp = lk.log_prior_full(tc, sizes, theta, alpha, fp, fn)

    padded, m_pad = pad_muts(data, 2)
    ax = MutAxis(mesh.mut_group, mesh.mut_index, 2,
                 local_mut_mask(m_pad, m, mesh.mut_index, 2, "cpu"))
    local = local_cols(padded, mesh.mut_index, 2)
    theta_p = torch.nn.functional.pad(theta, (0, m_pad - m), value=0.5)
    cols = slice(mesh.mut_index * 6, mesh.mut_index * 6 + 6)
    c1l, c0l = lk.log_prob_tables(theta_p[:, cols], fp, fn)
    got_ll = lk.ll_matrix(local, c1l, c0l, ax)
    got_lp = lk.log_prior_full(tc, sizes, theta_p[:, cols], alpha, fp, fn,
                               ax)
    return {"ll": (want_ll.numpy(), got_ll.numpy()),
            "lp": (want_lp.numpy(), got_lp.numpy()),
            "rs": (data.rs1.numpy(), local.rs1.numpy())}


def task_block_1x2(rank, payload):
    mesh = sharded.make_mesh(1, 2)
    refs = payload["ref2"]
    return {(impl, c): _sharded_block(mesh, M2, [ref], impl)
            for impl in ("scan", "lazy", "stream")
            for c, ref in enumerate(refs)}


def task_block_1x4(rank, payload):
    return _sharded_block(sharded.make_mesh(1, 4), M4, payload["ref4"],
                          "lazy")


def task_block_2x2(rank, payload):
    return _sharded_block(sharded.make_mesh(2, 2), M2, payload["ref2"],
                          "scan")


def _runner(mesh, block=5, ckpt=None):
    tc, tm = _port_cfgs(M2)
    return tmcmc.MCMCRunner(tc, tm, tpack(_data(M2), "cpu"), device="cpu",
                            block_size=block, checkpoint_dir=ckpt,
                            checkpoint_every=1, mesh=mesh)


def _result_np(res):
    if res is None:
        return None
    return [{f: getattr(r, f) for f in ("ML", "MAP", "DP_alpha", "FN", "FP",
                                        "assignments", "params",
                                        "mh_counts", "burn_in")}
            for r in res]


def task_chain_mesh(rank, payload):
    """2 chains over a 2 x 1 mesh, on the port's own draws."""
    runner = _runner(sharded.make_mesh(2, 1))
    res = runner.run((12, 3), seed=4, n_chains=2)
    return {"res": _result_np(res), "seeds": runner.seeds}


def task_resume(rank, payload):
    """A 1 x 2 run checkpointed every block, resumed by fresh runners, and
    the same checkpoint offered to a 2 x 1 mesh."""
    mesh = sharded.make_mesh(1, 2)
    ck = os.path.join(payload["tmp"], "ck")
    _runner(mesh, ckpt=ck).run((10, 2), seed=2)
    resumed = _runner(mesh, ckpt=ck).run((17, 2), seed=2)
    full = _runner(mesh).run((17, 2), seed=2)
    try:
        _runner(sharded.make_mesh(2, 1), ckpt=ck).run((20, 2), seed=2,
                                                       n_chains=2)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"resumed": _result_np(resumed), "full": _result_np(full),
            "refused": refused}


def task_streams(rank, payload):
    """TorchDraws under a 1 x 2 mesh: the shards' own streams differ, the
    replicated stream stays equal; a runner on them keeps its replicated
    state equal across the ranks."""
    from bnpc_tpu_torch.models.gibbs import _sweep_keys, fresh_row

    mesh = sharded.make_mesh(1, 2)
    tc, _ = _port_cfgs(M2)
    ax = MutAxis(mesh.mut_group, mesh.mut_index, 2)
    d = TorchDraws(7, "cpu")
    # Identical columns on both ranks: a newborn row differs only by the
    # stream it is drawn from.
    data = tpack(_data(M2), "cpu")
    _, _, k_beta = _sweep_keys(d, tc, ax)
    row = fresh_row(k_beta, 3, data, tc)
    after = d.uniform((4,))
    runner = _runner(mesh)
    res = runner.run((10, 2), seed=3)
    st = runner.final_states[0]
    return {"row": row.numpy(), "after": after.numpy(),
            "res": _result_np(res),
            "replicated": [st.assignment.numpy(), st.cluster_size.numpy(),
                           st.dp_alpha.numpy(), st.fp.numpy(),
                           st.fn.numpy()],
            "local_params": st.params.numpy()}


# ---------------------------------------------------------------------------
# Fixtures: one spawned world each
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(ref2, ref4, the 2-rank world's results, the 4-rank world's)."""
    w2 = _World(2, ["task_ops", "task_block_1x2", "task_chain_mesh",
                    "task_resume", "task_streams"],
                str(tmp_path_factory.mktemp("world2")))
    w4 = _World(4, ["task_block_2x2", "task_block_1x4"],
                str(tmp_path_factory.mktemp("world4")))
    ref4_path = os.path.join(w4.tmp, "ref4.pkl")
    helper = mp.get_context("spawn").Process(
        target=_feed_reference, args=(ref4_path, M4, 4, CHAIN_SEEDS[:1]))
    helper.start()
    try:
        ref2 = _jax_reference(M2, 2, CHAIN_SEEDS)
        w2.feed("ref2", ref2)
        w4.feed("ref2", ref2)
        helper.join()
        assert helper.exitcode == 0, "the 1 x 4 reference failed"
        with open(ref4_path, "rb") as f:
            ref4 = pickle.load(f)
        return ref2, ref4, w2.results(), w4.results()
    except BaseException:
        for p in [helper, *w2.ctx.processes, *w4.ctx.processes]:
            if p.is_alive():
                p.terminate()
        raise


@pytest.fixture(scope="module")
def ref2(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1], worlds[3]


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _assert_state(want, ranks, rtol=1e-6):
    """bnpc_tpu's state leaves against the ranks' states (leaf lists, the
    params of each rank its columns)."""
    for r in ranks[1:]:
        for f in (0, 2, 3, 4, 5):  # replicated leaves, bit for bit
            np.testing.assert_array_equal(ranks[0][f], r[f])
    params = np.concatenate([r[1] for r in ranks], axis=-1)
    np.testing.assert_array_equal(want[0], ranks[0][0])
    np.testing.assert_array_equal(want[2], ranks[0][2])
    live = want[2] > 0
    np.testing.assert_allclose(params[live], want[1][live], rtol=rtol)
    for f in (3, 4, 5):
        np.testing.assert_allclose(ranks[0][f], want[f], rtol=rtol)


def _assert_chain(ref, outs):
    """One chain's port outputs (one per rank of its mutation group, in
    shard order) against bnpc_tpu's reference; returns (births, split-merge
    moves)."""
    _assert_state(ref["states"][0], [o["one"] for o in outs])
    _assert_state(ref["states"][-1], [o["four"] for o in outs])
    births = sm = 0
    sizes = ref["init"][2]
    for s, want in enumerate(ref["rows"]):
        got = [{f: v[s] for f, v in o["rows"].items()} for o in outs]
        for g in got[1:]:
            for f in ("ml", "map_", "dp_alpha", "fp", "fn", "assignment",
                      "mh_counts"):
                np.testing.assert_array_equal(got[0][f], g[f], f)
        g = got[0]
        np.testing.assert_array_equal(g["assignment"], want["assignment"])
        np.testing.assert_array_equal(g["mh_counts"], want["mh_counts"])
        np.testing.assert_allclose(g["ml"], want["ml"], rtol=1e-5)
        np.testing.assert_allclose(g["map_"] - g["ml"],
                                   want["map_"] - want["ml"], rtol=1e-5,
                                   atol=1e-4)
        for f in ("dp_alpha", "fp", "fn"):
            np.testing.assert_allclose(g[f], want[f], rtol=1e-6)
        params = np.concatenate([o["params"] for o in got], axis=-1)
        np.testing.assert_allclose(params.astype(np.float32),
                                   want["params"].astype(np.float32),
                                   rtol=1e-3)
        new_sizes = ref["states"][s][2]
        if want["mh_counts"][1:3].sum():
            sm += 1
        else:
            births += int(((sizes == 0) & (new_sizes > 0)).sum())
        sizes = new_sizes
    return births, sm


def test_sharded_ll_matrix_and_prior(world2):
    """tests/test_sharding.py:25's check, and the masked log prior."""
    for out in world2:
        o = out["task_ops"]
        np.testing.assert_allclose(*o["ll"][::-1], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(*o["lp"][::-1], rtol=1e-5, atol=1e-4)
        # The local slice keeps the whole rows' counts.
        np.testing.assert_array_equal(*o["rs"])


@pytest.mark.parametrize("impl", ["scan", "lazy", "stream"])
def test_1x2_matches_make_sharded_block(impl, world2, ref2):
    """One step and a 4-step block on a 1 x 2 mesh, learned errors and
    split-merge on, against bnpc_tpu's make_sharded_block on the same
    keys; the sweep as the scan and as kernels 1 and 3's twins."""
    births = sm = 0
    for c, ref in enumerate(ref2):
        outs = [w["task_block_1x2"][impl, c] for w in world2]
        b, s = _assert_chain(ref, outs)
        births, sm = births + b, sm + s
    assert births > 0, "no Gibbs birth exercised the sharded patch"
    assert sm > 0, "no split-merge move exercised the sharded rg scan"


def test_1x4_padded_matches_make_sharded_block(world4):
    """m = 30 padded to 32 over a 1 x 4 mesh (masked columns)."""
    ref4, outs = world4
    _assert_chain(ref4[0], [o["task_block_1x4"] for o in outs])


def test_2x2_matches_make_sharded_block(world4, ref2):
    """Chain c of a 2 x 2 mesh: the ranks of chain shard c, held to
    bnpc_tpu's 1 x 2 block of chain c."""
    _, outs = world4
    for c, ref in enumerate(ref2):
        _assert_chain(ref, [o["task_block_2x2"] for o in outs
                            if o["task_block_2x2"]["chain"] == c])


def test_chain_mesh_equals_one_process(world2):
    """Under a 2 x 1 mesh each chain is the one-process runner's chain,
    bit for bit; rank 0 returns both, rank 1 nothing."""
    got = world2[0]["task_chain_mesh"]
    assert world2[1]["task_chain_mesh"]["res"] is None
    runner = _runner(None)
    want = _result_np(runner.run((12, 3), seed=4, n_chains=2))
    np.testing.assert_array_equal(got["seeds"], runner.seeds)
    assert len(got["res"]) == 2
    for g, w in zip(got["res"], want):
        for f, v in w.items():
            np.testing.assert_array_equal(g[f], v, f)


def test_resume_under_mesh(world2):
    """A resumed 1 x 2 run equals the uninterrupted one bit for bit; a
    checkpoint of a 1 x 2 mesh is refused by a 2 x 1 mesh, naming both
    shapes, on every rank."""
    got = world2[0]["task_resume"]
    for r, w in zip(got["resumed"], got["full"]):
        for f, v in w.items():
            np.testing.assert_array_equal(r[f], v, f)
    for out in world2:
        msg = out["task_resume"]["refused"]
        assert msg is not None and "1x2 mesh" in msg and "2x1" in msg


def test_shard_streams(world2):
    """Per-mutation draws come from each shard's own stream (the newborn
    rows of the same cell on identical columns differ); the replicated
    stream stays equal, and so does the replicated state of a TorchDraws
    run."""
    a, b = (w["task_streams"] for w in world2)
    assert not np.array_equal(a["row"], b["row"])
    np.testing.assert_array_equal(a["after"], b["after"])
    for x, y in zip(a["replicated"], b["replicated"]):
        np.testing.assert_array_equal(x, y)
    assert a["res"] is not None and b["res"] is None
    np.testing.assert_array_equal(a["res"][0]["assignments"][-1],
                                  a["replicated"][0])
    assert a["local_params"].shape == b["local_params"].shape == (N, M2 // 2)


def test_eager_refused_under_sharding():
    from bnpc_tpu_torch.models.gibbs import gibbs_sweep
    from bnpc_tpu_torch.state import init_state

    tc, _ = _port_cfgs(M2)
    data = tpack(_data(M2), "cpu")
    st = init_state(TorchDraws(0, "cpu"), tc, data, "cpu")
    with pytest.raises(ValueError, match="sharded mutation axis"):
        gibbs_sweep(TorchDraws(1, "cpu"), st, data, tc, impl="eager",
                    ax=MutAxis(group=object(), index=0, size=2))


# ---------------------------------------------------------------------------
# multihost.initialize (tests/test_multihost.py:16-60)
# ---------------------------------------------------------------------------


_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "LOCAL_WORLD_SIZE")


def test_initialize_single_process_noop(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)

    def explode(*a, **k):
        raise AssertionError("init_process_group must not be called")

    monkeypatch.setattr(dist, "init_process_group", explode)
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False


def _fake_init(monkeypatch):
    seen = {}

    def fake(backend, **kwargs):
        seen.update(backend=backend, **kwargs)

    monkeypatch.setattr(dist, "init_process_group", fake)
    return seen


def test_initialize_env_parsing(monkeypatch):
    for var, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                   ("WORLD_SIZE", "4"), ("RANK", "2")):
        monkeypatch.setenv(var, v)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    seen = _fake_init(monkeypatch)
    assert multihost.initialize(device="cpu") is True
    assert seen["init_method"] == "tcp://10.0.0.1:1234"
    assert (seen["world_size"], seen["rank"]) == (4, 2)
    assert seen["backend"] == "gloo"
    assert seen["timeout"].total_seconds() <= 120


def test_initialize_explicit_args_beat_env(monkeypatch):
    for var, v in (("MASTER_ADDR", "ignored"), ("MASTER_PORT", "1"),
                   ("WORLD_SIZE", "8"), ("RANK", "5")):
        monkeypatch.setenv(var, v)
    seen = _fake_init(monkeypatch)
    assert multihost.initialize("host:9", num_processes=2, process_id=1,
                                device="cpu")
    assert seen["init_method"] == "tcp://host:9"
    assert (seen["world_size"], seen["rank"]) == (2, 1)


def test_backend_choice(monkeypatch):
    """nccl only when every local rank has a card of its own."""
    assert multihost.choose_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.choose_backend("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.choose_backend("cuda", 4) == "nccl"


def test_make_mesh_too_small():
    """bnpc_tpu's message (parallel/sharded.py:38-48) on one process."""
    with pytest.raises(ValueError, match="need 4 devices for a 2x2 mesh, "
                                         "have 1"):
        sharded.make_mesh(2, 2)
