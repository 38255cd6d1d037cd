"""The port's training launcher replayed against the JAX package's
``repro.launch.train.main`` at SMOKE on the CPU: the port's ``main`` with
the flags' defaults (20 steps of 4 x 128, a checkpoint every 10) and the
same token store, from the same initial parameters (the JAX package's
seed-0 ``init_params``, carried across in place of the port's own draw),
gives per-step losses within the train-step tolerances of
``tests/test_torch_train.py`` (float32 rtol 1e-5, bfloat16 2e-2), also
through a failure: a host killed after step 12, a restore from the
step-10 checkpoint and the steps replayed."""
import argparse
import os
import sys

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.train.fault_tolerance as jft
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import params_from_numpy

LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
KILL_AFTER = 12


def _killing(supervisor_cls):
    """The supervisor with host3 killed after step KILL_AFTER, once."""

    class Killing(supervisor_cls):
        def run(self, state, step_fn, n_steps, start_step=0):
            done = []

            def step(st, i):
                st = step_fn(st, i)
                if i == KILL_AFTER and not done:
                    self.monitor.kill("host3")
                    done.append(i)
                return st
            return super().run(state, step, n_steps, start_step)
    return Killing


def _reference(monkeypatch, argv, dtype, kill):
    """Run the JAX package's main → (its per-step losses, its batches)."""
    real_get = jconfigs.get_config
    monkeypatch.setattr(jconfigs, "get_config", lambda arch, smoke=False:
                        real_get(arch, smoke).scaled(dtype=dtype))
    if kill:
        monkeypatch.setattr(jft, "TrainingSupervisor",
                            _killing(jft.TrainingSupervisor))
    real_jit = jax.jit
    losses, batches = [], []

    def recording_jit(fn, **kw):
        step = real_jit(fn, **kw)

        def run(params, opt, batch):
            out = step(params, opt, batch)
            losses.append(float(out[2]["loss"]))
            batches.append(np.asarray(batch["tokens"]))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jlaunch.main()
    monkeypatch.undo()
    return losses, batches


@pytest.mark.parametrize("dtype,kill", [("float32", False),
                                        ("bfloat16", False),
                                        ("float32", True)],
                         ids=["float32", "bfloat16", "float32-restore"])
def test_launcher_losses_equal_the_references(tmp_path, monkeypatch, dtype,
                                              kill):
    data = str(tmp_path / "data")
    common = ["--arch", "qwen3-14b", "--smoke", "--data", data]
    want, jbatches = _reference(
        monkeypatch, [*common, "--workdir", str(tmp_path / "jax")], dtype,
        kill)
    jc = jconfigs.get_config("qwen3-14b", smoke=True).scaled(dtype=dtype)
    tc = tconfigs.get_config("qwen3-14b", smoke=True).scaled(dtype=dtype)
    tree = jax.tree.map(np.asarray, japi.init_params(jc,
                                                     jax.random.PRNGKey(0)))
    monkeypatch.setattr(tlaunch, "get_config", lambda arch, smoke=False: tc)
    monkeypatch.setattr(tlaunch.api, "init_params", lambda cfg, seed, dev:
                        params_from_numpy(cfg, tree, device=dev))
    if kill:
        monkeypatch.setattr(tlaunch, "TrainingSupervisor",
                            _killing(tlaunch.TrainingSupervisor))
    res = tlaunch.main([*common, "--workdir", str(tmp_path / "torch"),
                        "--device", "cpu"])
    assert len(res.losses) == len(want) == 20 + (3 if kill else 0)
    np.testing.assert_allclose(res.losses, want, rtol=LOSS_TOL[dtype])
    assert res.steps == 20 and np.isfinite(res.grad_norms).all()
    events = [e["event"] for e in res.log if e["event"] != "straggler"]
    assert events == (["checkpoint", "failure", "restart", "checkpoint"]
                      if kill else ["checkpoint", "checkpoint"])
    if kill:
        assert len(res.checkpoints["restore_bytes"]) == 1
    for step in (10, 20):
        for root in ("jax", "torch"):
            assert os.path.exists(tmp_path / root / f"ckpt-{step}.blob")
    assert len(jbatches) == len(res.losses)


def test_launcher_flags_are_the_references_plus_device(monkeypatch):
    class Parsed(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise Parsed(real(self, [], namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as got:
        jlaunch.main()
    monkeypatch.undo()
    ref = vars(got.value.args[0])
    port = vars(tlaunch.parse_args([]))
    assert port.pop("device") is None
    # the default workdir lies under the temporary directory in both
    assert os.path.basename(port.pop("workdir")) == "repro_torch-train"
    ref.pop("workdir")
    assert port == ref


def test_launcher_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("qwen3-14b", smoke=True)
    args = tlaunch.parse_args(["--smoke", "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.run(cfg, args)
    assert not os.path.exists(tmp_path / "data")
