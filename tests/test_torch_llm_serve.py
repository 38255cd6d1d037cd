"""The port's LLM serving side against the JAX package's: the paged KV
bookkeeping and its tuned page table, the serving launcher's loop, and the
serve-step exports, on numpy-seeded inputs at the SMOKE size on the CPU.

The launcher's logits are held per step against the JAX package's
``make_decode_step`` fed the very same tokens, within 1e-4 of max |logit|
in float32 (sums in another order through two layers); its tokens are
compared only where the JAX top-2 margin exceeds that, since a near-tie
may break either way.  Page tables, free lists and key positions are
exact; the tuned page table's design and cost equal the JAX package's
with numpy ranking (the search is bit-identical).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import PROFILES as JPROFILES
from repro.models import api as japi
from repro.serve.kvcache import PagedKVCache as JPaged
from repro.serve.serve_step import make_decode_step as j_decode_step
from repro_torch import serve as tserve
from repro_torch.configs import get_config as tget
from repro_torch.core import PROFILES
from repro_torch.launch import serve as launcher
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import serve_step
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.serve_step import greedy_generate

TOL = 1e-4


def _ops(seed, n=300):
    """A random sequence of page-pool operations."""
    rng = np.random.default_rng(seed)
    live, nxt, ops = [], 0, []
    for _ in range(n):
        r = rng.random()
        if r < 0.2 or not live:
            ops.append(("add", nxt))
            live.append(nxt)
            nxt += 1
        elif r < 0.85:
            ops.append(("append", int(rng.choice(live)),
                        int(rng.integers(1, 40))))
        else:
            sid = int(rng.choice(live))
            live.remove(sid)
            ops.append(("release", sid))
    return ops


def _apply(pool, ops):
    for op in ops:
        if op[0] == "add":
            pool.add_sequence(op[1])
        elif op[0] == "append":
            pool.append_tokens(op[1], op[2])
        else:
            pool.release(op[1])
    return pool


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_kv_cache_bookkeeping_equals_the_jax_one(seed):
    ops = _ops(seed)
    mine = _apply(PagedKVCache(n_pages=4096), ops)
    ref = _apply(JPaged(n_pages=4096), ops)
    assert mine.tables == ref.tables and mine.free == ref.free \
        and mine.lengths == ref.lengths
    a, b = mine.key_positions(), ref.key_positions()
    for f in ("keys", "lo", "hi", "weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_paged_kv_cache_exhaustion_raises_as_the_jax_one():
    for cls in (PagedKVCache, JPaged):
        pool = cls(n_pages=2, page_tokens=4)
        pool.add_sequence(0)
        with pytest.raises(MemoryError, match="exhausted"):
            pool.append_tokens(0, 9)


def test_page_table_tunes_to_the_jax_design_and_cost():
    ops = _ops(5, 600)
    mine = _apply(PagedKVCache(n_pages=8192), ops)
    ref = _apply(JPaged(n_pages=8192), ops)
    got = mine.tune_table("host_dram", score_backend="numpy")
    want = ref.tune_table("host_dram")
    assert got.design.describe() == want.design.describe()
    assert got.cost == want.cost
    assert mine.modeled_lookup_cost("host_dram", score_backend="numpy") == \
        ref.modeled_lookup_cost("host_dram")
    # ranked through the candidate scorer's plain version on the CPU
    on_cpu = mine.tune_table("host_dram", device="cpu")
    assert on_cpu.design.describe() == want.design.describe()
    assert on_cpu.cost == pytest.approx(want.cost, rel=1e-6)


def test_hbm_profile_is_the_cards_not_the_v5e():
    # the card's measured memory is "h100_hbm"; "hbm" is the v5e's in both
    # packages, and the pool still defaults to it, as the reference's does
    h100, v5e = PROFILES["h100_hbm"], JPROFILES["hbm"]
    assert (h100.latency, h100.bandwidth) != (v5e.latency, v5e.bandwidth)
    assert h100.bandwidth > v5e.bandwidth      # an H100, not a v5e
    assert (PROFILES["hbm"].latency, PROFILES["hbm"].bandwidth) == \
        (v5e.latency, v5e.bandwidth)
    pool = _apply(PagedKVCache(n_pages=1024), _ops(7))
    table = pool.tune_table("h100_hbm", score_backend="numpy")
    assert table.cost > 0
    ref = _apply(JPaged(n_pages=1024), _ops(7))
    got = pool.tune_table(score_backend="numpy")
    want = ref.tune_table()
    assert got.design.describe() == want.design.describe()
    assert got.cost == want.cost


@pytest.fixture(scope="module")
def served():
    jc = jget("qwen3_14b", smoke=True).scaled(dtype="float32")
    tc = tget("qwen3_14b", smoke=True).scaled(dtype="float32")
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    res = launcher.run(tc, tp, requests=8, steps=32, batch=4, max_len=128,
                       device="cpu", seed=0, keep_logits=True)
    return jc, jp, tc, tp, res


def test_launcher_queue_is_the_jax_launchers(served):
    jc = served[0]
    rng = np.random.default_rng(0)                # launch/serve.py:34-35
    want = [rng.integers(1, jc.vocab, int(rng.integers(4, 12)))
            .astype(np.int32) for _ in range(8)]
    got = launcher.make_queue(served[2], 8, 0)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_launcher_steps_replay_through_the_jax_decode_step(served):
    jc, jp, tc, tp, res = served
    assert len(res.feeds) == len(res.logits) == 32
    decode = jax.jit(j_decode_step(jc))
    state = japi.init_decode_state(jc, jp, 4, 128)
    for pos, feed in enumerate(res.feeds):
        logits, state = decode(jp, {"tokens": jnp.asarray(feed)}, state, pos)
        want = np.asarray(logits)[:, :jc.vocab]
        got = res.logits[pos][:, :jc.vocab]
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < TOL, pos
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) / scale > TOL
        assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def test_launcher_keeps_the_reference_loop_and_its_counts(served):
    jc, jp, tc, tp, res = served
    st = res.stats
    assert st["steps"] == 32 and st["device"] == "cpu"
    assert st["out_tokens"] >= sum(len(t) for t in res.tokens.values())
    assert all(len(t) == launcher.OUT_TOKENS for t in res.tokens.values())
    assert st["completed"] == len(res.tokens) >= 4
    assert len(st["step_walls_s"]) == 32
    # each feed is a prompt token, the slot's last output, token 1 or 0
    queue = launcher.make_queue(tc, 8, 0)
    first = res.feeds[0][:, 0]
    assert list(first) == [int(q[0]) for q in queue[:4]]
    # requests still in flight after 32 steps keep their pages, and the
    # page table is tuned for the card's memory over them
    assert res.page_table is not None and res.page_table.cost > 0


def test_launcher_flags_and_main_on_the_cpu(capsys):
    args = launcher.parse_args([])
    assert args.smoke is True and args.steps == 32 and args.max_len == 128
    assert launcher.parse_args(["--no-smoke"]).smoke is False
    launcher.main(["--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[done] 3 steps" in out and "reduced=True" in out


def test_launcher_needs_room_for_the_shared_position(served):
    jc, jp, tc, tp, res = served
    with pytest.raises(ValueError, match="max_len"):
        launcher.run(tc, tp, steps=9, max_len=8, device="cpu")


def test_serve_exports_the_steps_and_greedy_generates(served):
    assert tserve.make_prefill_step is serve_step.make_prefill_step
    assert tserve.make_decode_step is serve_step.make_decode_step
    tc, tp = served[2], served[3]
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        1, tc.vocab, (2, 5)).astype(np.int32))
    out = greedy_generate(tc, tp, prompt, 4, 16)
    assert out.shape == (2, 4) and int(out.max()) < tc.vocab
    pre = tserve.make_prefill_step(tc)(tp, {"tokens": prompt})
    logits = pre[:, :tc.vocab]
    top2 = logits.topk(2).values
    sure = (top2[:, 0] - top2[:, 1]) / logits.abs().max() > TOL
    assert torch.equal(out[:, 0][sure], logits.argmax(-1)[sure])


def test_launcher_main_replays_the_jax_main_at_its_default_arch(
        monkeypatch, capsys):
    """Both packages' ``main`` at their defaults (zamba2-1.2b SMOKE, 8
    requests, batch 4, 32 steps; float32 here) from the JAX package's
    seed-0 parameters: the port's feeds equal the JAX loop's and each
    step's logits agree within 1e-4 of max |logit|, its tokens wherever
    the JAX top-2 margin exceeds that; the two summaries count the same
    tokens and requests."""
    import sys

    import repro.configs as jconfigs
    from repro.launch import serve as jlauncher
    from repro_torch import configs as tconfigs
    real_jget, real_tget = jconfigs.get_config, tconfigs.get_config
    monkeypatch.setattr(jconfigs, "get_config", lambda a, smoke=False:
                        real_jget(a, smoke).scaled(dtype="float32"))
    trees, steps = [], []
    real_init, real_jit = japi.init_params, jax.jit

    def init(cfg, rng):
        p = real_init(cfg, rng)
        trees.append(jax.tree.map(np.asarray, p))
        return p

    def recording_jit(fn, **kw):
        step = real_jit(fn, **kw)

        def run(params, batch, state, pos):
            logits, state = step(params, batch, state, pos)
            steps.append((np.asarray(batch["tokens"]), np.asarray(logits)))
            return logits, state
        return run

    monkeypatch.setattr(japi, "init_params", init)
    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(sys, "argv", ["serve"])
    jlauncher.main()
    want_out = capsys.readouterr().out
    monkeypatch.undo()

    monkeypatch.setattr(tconfigs, "get_config", lambda a, smoke=False:
                        real_tget(a, smoke).scaled(dtype="float32"))
    monkeypatch.setattr(launcher, "get_config", tconfigs.get_config)
    runs = []
    real_run = launcher.run

    def run(cfg, params, **kw):
        runs.append(real_run(cfg, params, keep_logits=True, **kw))
        return runs[-1]

    monkeypatch.setattr(launcher.api, "init_params",
                        lambda cfg, gen, device: params_from_numpy(
                            cfg, trees[0], device=device))
    monkeypatch.setattr(launcher, "run", run)
    launcher.main(["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert "zamba2-1.2b" in got_out and "zamba2-1.2b" in want_out
    res = runs[0]
    vocab = real_tget("zamba2-1.2b", True).vocab
    assert len(res.feeds) == len(steps) == 32
    for pos, ((feed, want), got) in enumerate(zip(steps, res.logits)):
        np.testing.assert_array_equal(res.feeds[pos], feed)
        want, got = want[:, :vocab], got[:, :vocab]
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < TOL, pos
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) / scale > TOL
        assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])

    def summary(out):
        line = next(x for x in out.splitlines() if x.startswith("[done]"))
        return line.split(",")[:3]
    assert summary(got_out) == summary(want_out)
