"""The port's ring attention against the JAX package's XLA ring.

The JAX reference is ``ring_attention(impl="xla")`` (the ``ppermute`` ring)
on the first n of the 8 virtual CPU devices, forward and ``jax.vjp``
gradients, jitted once per (n, causal); this file never calls the JAX
``impl="pallas"`` ring (its interpreter is slow on the CPU and the JAX tests
already hold it against the XLA ring).  On the CPU the port's ring runs its
plain versions: ``ring_attention`` with ``impl="xla"`` (autograd through the
per-hop ring) and ``impl="pallas"`` (``RingAttention`` over the two-way
shard functions), and the one-way shard functions driven directly.  The
same numpy-made q, k, v, key-pad mask and output cotangent go to both, at
n = 2, 3, 4 and 8 ranks, non-causal, causal, with pads, and with a dead
row (a causal query whose every visible key is padded attends uniformly
over the keys of its live blocks).  Tolerance: 1e-5 of each tensor's
largest magnitude (f32; the two sum in other orders).

The kernels' launch plan (``ring_plan``: per ring step with a live rank,
one forward launch, or one dK/dV and one dQ launch, each rank finalized at
its last live step; one landing launch per backward call), the argument
tables the kernels read and the backward's argument struct are checked in
pure Python.  A tiny dead-row case pins what the backward kernels must
keep: the dead row's dO reaches dv at keys in its causal future.

Then the model: a tiny ``IQ`` forward in latent mode with
``sequence_parallel`` on a ``seq`` 4 mesh against the JAX ``IQ(...,
mesh=seq_mesh)`` (parameters carried by ``from_flax``'s inverse,
``to_flax``), and one latent train step of the port's ring path against
its non-ring path.
"""

import ctypes
import functools
import types

import jax
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.ops.ring_attention import ring_attention as jax_ring
from blt_vqg_tpu.parallel.mesh import build_mesh as jax_build_mesh
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.convert import to_flax
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.ops.kernels import ring_attention as tra
from blt_vqg_tpu_torch.ops.ring_attention import ring_attention
from blt_vqg_tpu_torch.parallel import build_mesh
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import make_batch, make_train_step
from test_torch_train import TINY, VOCAB, jax_eps, make_weights


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


# (ranks, batch, chunk, heads, head_dim, causal, pad)
CASES = {
    "n4_causal": (4, 2, 3, 2, 8, True, None),
    "n4_causal_pad": (4, 2, 3, 2, 8, True, "tail"),
    "n4_dead_row": (4, 2, 3, 2, 8, True, "dead"),
    "n4_pad": (4, 2, 3, 2, 8, False, "tail"),
    "n2_causal_pad": (2, 3, 5, 2, 8, True, "tail"),
    "n3_pad": (3, 2, 4, 2, 8, False, "random"),
    "n8_dead_row": (8, 1, 2, 2, 8, True, "dead"),
}


def _inputs(case):
    n, b, c, h, d, causal, pad = CASES[case]
    t = n * c
    r = np.random.RandomState(len(case) + n)
    f = lambda *s: r.randn(*s).astype(np.float32)
    q = f(b, t, h, d) * d ** -0.5
    k, v, do = f(b, t, h, d), f(b, t, h, d), f(b, t, h, d)
    kv_pad = np.zeros((b, t), bool)
    if pad == "tail":
        kv_pad = np.arange(t)[None, :] >= r.randint(t // 2, t, b)[:, None]
    elif pad == "random":
        kv_pad = r.rand(b, t) < 0.3
        kv_pad[:, 0] = False
    elif pad == "dead":             # key 0 padded: causal query 0 is dead
        kv_pad[:, 0] = True
        kv_pad[:, t - 2:] = True
    return q, k, v, kv_pad, do


@functools.lru_cache(maxsize=None)
def _jax_ring_fn(n: int, causal: bool):
    """Jitted (o, dq, dk, dv) of the JAX XLA ring on n devices."""
    mesh = jax_build_mesh((n,), ("seq",))

    def fn(q, k, v, kv_pad, do):
        o, vjp = jax.vjp(lambda q, k, v: jax_ring(
            q, k, v, mesh, axis="seq", causal=causal, kv_pad=kv_pad,
            impl="xla"), q, k, v)
        return (o, *vjp(do))

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _want(case):
    n, causal = CASES[case][0], CASES[case][5]
    return [np.asarray(x) for x in _jax_ring_fn(n, causal)(*_inputs(case))]


@pytest.fixture(scope="module")
def jax_devices(eight_devices):
    return eight_devices


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_ring_attention_matches_jax(jax_devices, case, impl):
    n, causal = CASES[case][0], CASES[case][5]
    q, k, v, kv_pad, do = _inputs(case)
    mesh = build_mesh((n,), ("seq",), device="cpu")
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ring_attention(qt, kt, vt, mesh, axis="seq", causal=causal,
                       kv_pad=torch.from_numpy(kv_pad), impl=impl)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o.detach(), *grads),
                          _want(case)):
        assert_close(g.numpy(), w, f"{case} {impl} {name}")


def _shards(x, n):
    """[B, T, ...] numpy -> the ranks' shards [n, B, T / n, ...]."""
    x = torch.from_numpy(x)
    return x.view(x.shape[0], n, x.shape[1] // n, *x.shape[2:]).transpose(0, 1)


def _unshard(x):
    return x.transpose(0, 1).reshape(x.shape[1], -1, *x.shape[3:]).numpy()


@pytest.mark.parametrize("case", ["n4_dead_row", "n2_causal_pad", "n3_pad",
                                  "n8_dead_row"])
def test_one_way_shards_match_jax(jax_devices, case):
    """The one-way forward and backward shard functions, driven directly;
    their residuals equal the two-way ring's (the same live blocks)."""
    n, causal = CASES[case][0], CASES[case][5]
    q, k, v, kv_pad, do = (_shards(x, n) for x in _inputs(case))
    ring = build_mesh((n,), ("seq",), device="cpu").ring()
    o, m, l = tra.ring_attention_fwd_shard(q, k, v, kv_pad, ring=ring,
                                           causal=causal, return_lse=True)
    grads = tra.ring_attention_bwd_shard(q, k, v, kv_pad, o, m, l, do,
                                         ring=ring, causal=causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), _want(case)):
        assert_close(_unshard(g), w, f"{case} one-way {name}")
    _, m2, l2 = tra.ring_attention_fwd_bidir_shard(
        q, k, v, kv_pad, ring=ring, causal=causal, return_lse=True)
    assert_close(m2.numpy(), m.numpy(), "m")
    assert_close(l2.numpy(), l.numpy(), "l")


def test_schedules_visit_every_live_block_once():
    """Over its steps each rank computes every block that is not entirely
    in its future exactly once, on both schedules; the two-way ring takes
    n // 2 + 1 (even n) or (n - 1) // 2 + 1 (odd n) steps."""
    for n in (2, 3, 4, 5, 8):
        for bidir in (False, True):
            steps = tra.ring_steps(n, bidir)
            assert steps == (n if not bidir else n // 2 + 1)
            for causal in (False, True):
                for r in range(n):
                    seen = [src for s in range(steps)
                            for _, src in tra.visits(n, s, r, causal, bidir)]
                    want = range(r + 1) if causal else range(n)
                    assert sorted(seen) == list(want), (n, bidir, causal, r)


def _live_steps(n, causal, bidir):
    """{rank: [steps where it computes a block]}, from ``visits``."""
    return {r: [s for s in range(tra.ring_steps(n, bidir))
                if tra.visits(n, s, r, causal, bidir)] for r in range(n)}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_forward_plan(n):
    """The forward's launch plan, both schedules, causal and not: each
    step's launch covers exactly the ranks with a live block there, with
    their visits; each rank starts its carry at its first live step and
    finalizes exactly once, at its last; a call launches once per step
    with a live rank."""
    for bidir in (False, True):
        for causal in (False, True):
            plan = tra.ring_plan(n, causal, bidir)
            live = _live_steps(n, causal, bidir)
            assert len(plan) == tra.ring_steps(n, bidir)
            for s, entries in enumerate(plan):
                assert [e[0] for e in entries] == [r for r in range(n)
                                                   if s in live[r]]
                for r, vis, first, last in entries:
                    assert list(vis) == tra.visits(n, s, r, causal, bidir)
                    assert first == (s == live[r][0])
                    assert last == (s == live[r][-1])
            finals = [e[0] for entries in plan for e in entries if e[3]]
            assert sorted(finals) == list(range(n)), (bidir, causal)
            busy = {s for steps in live.values() for s in steps}
            assert sum(1 for entries in plan if entries) == len(busy)


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry the kernel
    path calls, in order, and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        if entry.startswith("_"):
            raise AttributeError(entry)
        return lambda args, stream: self.calls.append(entry) or 0


def _kernel_path_calls(monkeypatch, bwd: bool, bidir: bool, n: int = 4):
    """The library entries one causal call of the kernel path launches on
    n ranks, and its counter, with the library and the stream stood in
    for: the schedule, its tables and its argument structs are the real
    ones, on CPU tensors."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    lib = _RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((n, 1, 2, 1, 8), generator=gen)
                   for _ in range(4))
    pad = torch.zeros((n, 1, 2), dtype=torch.bool)
    ring = build_mesh((n,), ("seq",), device="cpu").ring()
    counter = types.SimpleNamespace(launches=0)
    if bwd:
        m = torch.zeros((n, 1, 2, 1))
        tra._ring_bwd(q, k, v, pad, q, m, m + 1.0, do, ring, True, bidir,
                      True, counter)
    else:
        tra._ring_fwd(q, k, v, pad, ring, True, bidir, True, counter)
    return lib.calls, counter.launches


def _busy_steps(n, causal, bidir):
    """Steps at which some rank computes a block, from ``visits``."""
    return sum(1 for s in range(tra.ring_steps(n, bidir))
               if any(tra.visits(n, s, r, causal, bidir) for r in range(n)))


def test_forward_launches_per_call_at_seq4(monkeypatch):
    """Causal on 4 ranks: 3 two-way and 4 one-way launches per call, in
    the plan and in what the kernel path launches."""
    for bidir, want in ((True, 3), (False, 4)):
        assert sum(1 for e in tra.ring_plan(4, True, bidir) if e) == want
        assert _busy_steps(4, True, bidir) == want
        calls, counted = _kernel_path_calls(monkeypatch, False, bidir)
        assert calls == ["bvq_ring_fwd_step"] * want
        assert counted == want


@pytest.mark.parametrize("n", [3, 4, 8])
def test_forward_tables_encode_the_plan(n):
    """The argument tables the forward kernel reads at each step (ranks,
    block counts, first/last flags, directions and sources) decode back
    to the plan."""
    for bidir in (False, True):
        for causal in (False, True):
            plan = tra.ring_plan(n, causal, bidir)
            for entries, t in zip(plan, tra._step_tables(n, causal, bidir)):
                assert t.nent == len(entries)
                for e, (r, vis, first, last) in enumerate(entries):
                    info = t.info[e]
                    assert (t.rank[e], info & 3, bool(info & 4),
                            bool(info & 8)) == (r, len(vis), first, last)
                    assert [((info >> (4 + j)) & 1, t.src[2 * e + j])
                            for j in range(len(vis))] == list(vis)


@pytest.mark.parametrize("bidir,want", [(True, 7), (False, 9)])
def test_backward_launches_per_call_at_seq4(monkeypatch, bidir, want):
    """Causal on 4 ranks, the kernel path launches a dK/dV and a dQ kernel
    at each step where some rank computes a block, then one landing
    kernel: 7 two-way and 9 one-way per call."""
    busy = _busy_steps(4, True, bidir)
    calls, counted = _kernel_path_calls(monkeypatch, True, bidir)
    assert calls == (["bvq_ring_bwd_dkdv", "bvq_ring_bwd_dq"] * busy
                     + ["bvq_ring_land"])
    assert counted == len(calls) == want


@pytest.mark.parametrize("n", [3, 4, 8])
def test_backward_tables_encode_the_plan(n):
    """The backward reads the same step tables: its dK/dV launch's pairs
    are every (entry, visiting block) of the step, in order, and the dQ
    launch starts each rank's carry at the rank's first live step."""
    for bidir in (False, True):
        for causal in (False, True):
            plan = tra.ring_plan(n, causal, bidir)
            live = _live_steps(n, causal, bidir)
            for s, (entries, t) in enumerate(
                    zip(plan, tra._step_tables(n, causal, bidir))):
                if not entries:
                    assert t is None
                    continue
                pairs = [(p >> 1, p & 1) for p in t.pair[:t.npair]]
                assert pairs == [(e, j) for e, (_, vis, _, _)
                                 in enumerate(entries)
                                 for j in range(len(vis))]
                for e, j in pairs:
                    r, vis = t.rank[e], entries[e][1]
                    assert ((t.info[e] >> (4 + j)) & 1,
                            t.src[2 * e + j]) == vis[j]
                    assert bool(t.info[e] & 4) == (s == live[r][0])


def test_backward_args_layout():
    """``RingBwdArgs`` mirrors the C struct: its fields in the documented
    order at their C offsets (ints 4 bytes, longs and pointers 8, aligned
    to their size), then the step table."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    order = ([(f, 4, 1) for f in ("act_bf16", "causal", "ranks", "batch",
                                  "heads", "chunk", "dim")]
             + [(f, 8, 1) for f in ("rs", "sb", "slot_rs", "q", "dout", "m",
                                    "l", "delta", "dq")]
             + [(f, 8, 2) for f in ("k", "v", "pad", "rider")]
             + [(f, 8, 1) for f in ("dq_out", "dk", "dv")] + [("ret", 8, 2)])
    off = 0
    for name, size, count in order:
        off = -(-off // size) * size
        assert getattr(_build.RingBwdArgs, name).offset == off, name
        off += size * count
    r = _build.RING_MAX_RANKS
    assert _build.RingBwdArgs.step.offset == off
    assert [getattr(_build.RingStep, f).offset for f in
            ("nent", "npair", "rank", "info", "src", "pair")] == [
                0, 4, 8, 8 + 4 * r, 8 + 8 * r, 8 + 16 * r]
    assert ctypes.sizeof(_build.RingBwdArgs) == off + 8 + 24 * r
    assert [f for f, *_ in _build.RingBwdArgs._fields_] == [
        f for f, *_ in order] + ["step"]


def test_dead_row_reaches_dv_at_future_keys(jax_devices):
    """A causal query whose every visible key is padded attends uniformly
    over its live blocks' keys, its causal future included: with dO zero
    but on that row, dv is nonzero exactly at the keys of its rank's
    diagonal block, in the port's plain backward as in JAX's ring.  A
    kernel that skipped future tiles without asking for dead rows would
    drop these."""
    n, causal = CASES["n4_dead_row"][0], True
    q, k, v, kv_pad, do = _inputs("n4_dead_row")
    c = q.shape[1] // n
    do = np.zeros_like(do)
    do[:, 0] = 1.0                 # rank 0's query 0 is dead: key 0 padded
    want = [np.asarray(x) for x in _jax_ring_fn(n, causal)(
        q, k, v, kv_pad, do)]
    sh = [_shards(x, n) for x in (q, k, v, kv_pad, do)]
    ring = build_mesh((n,), ("seq",), device="cpu").ring()
    o, m, l = tra.ring_attention_fwd_shard(*sh[:4], ring=ring,
                                           causal=causal, return_lse=True)
    assert bool((m[0, :, 0] <= 0.5 * tra.NEG_INF).all())
    dv = _unshard(tra.ring_attention_bwd_shard(*sh[:4], o, m, l, sh[4],
                                               ring=ring, causal=causal)[2])
    assert_close(dv, want[3], "dead-row dv")
    assert np.abs(dv[:, 1:c]).min() > 0     # keys after query 0
    assert np.abs(dv[:, c:]).max() == 0     # blocks rank 0 never computes


def test_cpu_takes_the_plain_version():
    q, k, v, kv_pad, do = (_shards(x, 4) for x in _inputs("n4_causal_pad"))
    ring = build_mesh((4,), ("seq",), device="cpu").ring()
    names = ("ring_attention_fwd_shard", "ring_attention_fwd_bidir_shard",
             "ring_attention_bwd_shard", "ring_attention_bwd_bidir_shard")
    before = [getattr(tra, n).launches for n in names]
    o, m, l = tra.ring_attention_fwd_bidir_shard(
        q, k, v, kv_pad, ring=ring, causal=True, return_lse=True)
    got = tra.ring_attention_bwd_bidir_shard(q, k, v, kv_pad, o, m, l, do,
                                             ring=ring, causal=True)
    want = tra.ring_attention_bwd_bidir_shard_ref(q, k, v, kv_pad, o, m, l,
                                                  do, ring=ring, causal=True)
    assert [getattr(tra, n).launches for n in names] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ring.hop_bytes > 0     # the hops are real copies


def test_mesh_and_shape_checks():
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        build_mesh((2, 4), ("data", "seq"), device="cpu")
    mesh = build_mesh((1, 4), ("data", "seq"), device="cpu")
    assert mesh.shape == {"data": 1, "seq": 4}
    x = torch.zeros((1, 10, 2, 8))
    with pytest.raises(ValueError, match="must divide"):
        ring_attention(x, x, x, mesh, axis="seq")
    out = ring_attention(x[:, :8], x[:, :8], x[:, :8], mesh, axis="seq",
                         batch_axis="data")
    assert out.shape == (1, 8, 2, 8)


# ---------------------------------------------------------------------------
# the model on a seq 4 mesh: the decoder's self-attention (T 12) rings; the
# posterior (T 13) and context (T 3) encoders and cross-attention do not
SP = dict(TINY, max_q_length=12)


@pytest.fixture(scope="module")
def sp_setup():
    weights = make_weights(3)
    params, stats = to_flax(weights)
    batch = make_batch(Config(**SP), VOCAB, 4, np.random.RandomState(5),
                       device="cpu")
    assert bool((batch["target"] == 0).any())
    return {"weights": weights,
            "variables": {"params": params, "batch_stats": stats},
            "batch": batch,
            "np_batch": {k: v.numpy() for k, v in batch.items()}}


def _sp_model(weights, impl, sequence_parallel=True):
    cfg = Config(**SP, sequence_parallel=sequence_parallel,
                 ring_attention_impl=impl)
    model = IQ(cfg, VOCAB, mesh=build_mesh((4,), ("seq",), device="cpu"))
    model.load_state_dict(weights)
    return cfg, model


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_iq_forward_matches_jax(jax_devices, sp_setup, impl):
    jcfg = JaxConfig(**SP, sequence_parallel=True)
    seq_mesh = jax_build_mesh((4,), ("seq",))
    key = jax.random.key(11)
    b = sp_setup["np_batch"]
    outs = jax.jit(lambda v, batch: JaxIQ(jcfg, VOCAB, mesh=seq_mesh).apply(
        v, batch["images"], batch["context"], batch["posterior"],
        batch["target"], latent_mode=True, train=False,
        rngs={"latent": key}))(sp_setup["variables"], b)
    eps = torch.from_numpy(jax_eps(sp_setup["variables"], jcfg, key))
    _, model = _sp_model(sp_setup["weights"], impl)
    t = sp_setup["batch"]
    with torch.no_grad():
        logits, z_logit, kld, _ = model(t["images"], t["context"],
                                        t["posterior"], t["target"],
                                        latent_mode=True, eps=eps)
    assert model.mesh.ring().hop_bytes > 0      # the decoder rang
    assert_close(logits.numpy(), outs[0], "logits")
    assert_close(z_logit.numpy(), outs[1], "z_logit")
    assert_close(kld.numpy(), outs[2], "kld")


def test_train_step_ring_matches_plain_path(sp_setup):
    """One latent train step on the ring path (the two-way shard functions'
    plain versions) against the same step without sequence parallelism."""
    eps = torch.from_numpy(np.random.RandomState(2).randn(
        4, SP["latent_dim"]).astype(np.float32))
    results = []
    for sp in (True, False):
        cfg, model = _sp_model(sp_setup["weights"], "pallas", sp)
        state = create_train_state(cfg, model, seed=None)
        before = tra.ring_attention_bwd_bidir_shard.launches
        _, metrics = make_train_step(cfg, True)(
            state, sp_setup["batch"], torch.Generator().manual_seed(0), eps)
        assert tra.ring_attention_bwd_bidir_shard.launches == before
        results.append((metrics, {n: p.detach().clone() for n, p in
                                  model.named_parameters()}))
    (m_ring, p_ring), (m_plain, p_plain) = results
    for name in ("loss", "rec", "kld", "aux", "elbo"):
        assert_close(m_ring[name].numpy(), m_plain[name].numpy(), name)
    for name, w in p_plain.items():
        assert_close(p_ring[name].numpy(), w.numpy(), name)
