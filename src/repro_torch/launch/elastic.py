"""Elastic, fault-tolerant training: the CloudCoordinator applied to training
(the port of ``repro.launch.elastic``).

CloudSim's coordinator senses datacenter health and migrates VMs; here it
senses worker health (an injected failure) and "migration" is a restore of
the latest checkpoint: a training job's VM image is its (params, opt_state)
checkpoint.  ``ElasticRunner`` drives ``run_training`` under supervision:

  1. run until failure (or completion);
  2. on a failure, shrink the logical set of workers (a lost node);
  3. ``run_training`` restores the latest checkpoint and continues;
  4. repeat up to ``max_restarts``.

The engine plans each restart: ``plan_restart`` simulates the remaining
work as cloudlets over the surviving hosts, and over the whole set after
the repair time, and picks the shorter makespan (the paper's "evaluate
before deploying" loop, pointed at training itself).  On one card the
shrunken set is logical, as in the reference on a CPU.

Only ``launch.train.InjectedFailure`` counts as a lost node.  A CUDA launch
fault, an illegal address or an out-of-memory error is a ``RuntimeError``
as well; retrying it would hide a broken kernel, so it propagates.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.ckpt import latest_step
from repro_torch.core import SPACE_SHARED, Scenario, resolve_device, simulate
from repro_torch.core import scenarios as builders
from repro_torch.launch.train import InjectedFailure, run_training


@dataclasses.dataclass
class RestartDecision:
    finish_on_survivors_s: float
    wait_for_repair_s: float
    choice: str


def restart_scenario(work_mi: float, n_workers: int, n_hosts: int,
                     delay: float, device=None) -> Scenario:
    """One DC of ``max(n_workers, 1)`` space-shared 1,000-MIPS hosts, of
    which the first ``n_hosts`` exist, each running one VM with an equal
    share of ``work_mi`` submitted at ``delay`` (data-parallel training
    splits its work evenly across the workers)."""
    dev = resolve_device(device)
    width = max(n_workers, 1)
    exists = np.zeros((1, width), bool)
    exists[0, :n_hosts] = True
    hosts = builders.uniform_hosts(1, width, cores=1, mips=1000.0,
                                   ram_mb=1e6, exists=exists, device=dev)
    vms = builders.uniform_vms(n_hosts, ram_mb=1.0, bw_mbps=1.0, device=dev)
    cl = builders.make_cloudlets(
        np.arange(n_hosts), np.full(n_hosts, work_mi / max(n_hosts, 1)),
        np.full(n_hosts, delay), input_mb=0.0, output_mb=0.0, device=dev)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cl,
                    market=builders.uniform_market(1, device=dev),
                    policy=builders.make_policy(
                        host_policy=SPACE_SHARED, vm_policy=SPACE_SHARED,
                        core_reserving=True, horizon=1e9, device=dev))


def plan_restart(steps_remaining: int, step_time_s: float, n_workers: int,
                 n_survivors: int, repair_time_s: float,
                 device=None) -> RestartDecision:
    """Simulate "the remaining work on the survivors" against "wait for
    the repair, then all workers" (``simulate`` on ``device``, ``None``: the
    GPU) and pick the shorter makespan."""
    work_mi = steps_remaining * step_time_s * 1000.0   # 1000 MIPS host = 1x

    def makespan(n_hosts: int, delay: float) -> float:
        scn = restart_scenario(work_mi, n_workers, n_hosts, delay, device)
        return float(simulate(scn, device=device).makespan)

    on_survivors = makespan(n_survivors, 0.0)
    after_repair = makespan(n_workers, repair_time_s)
    choice = "survivors" if on_survivors <= after_repair else "wait_for_repair"
    return RestartDecision(on_survivors, after_repair, choice)


class ElasticRunner:
    """``run_training`` of ``cfg`` on ``device`` (``None``: the GPU),
    restarted from the latest checkpoint in ``ckpt_dir`` after each
    injected failure."""

    def __init__(self, cfg, ckpt_dir: str, *, steps: int = 60,
                 global_batch: int = 8, seq_len: int = 64,
                 ckpt_every: int = 10, max_restarts: int = 3,
                 n_workers: int = 4, repair_time_s: float = 600.0,
                 device=None):
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.device = device
        self.kw = dict(steps=steps, global_batch=global_batch,
                       seq_len=seq_len, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir, device=device)
        self.max_restarts = max_restarts
        self.n_workers = n_workers
        self.repair_time_s = repair_time_s
        self.events: list[dict] = []

    def run(self, fail_at_steps: list[int] | None = None) -> dict:
        """Train to the end; ``fail_at_steps`` injects one failure per run,
        in order.  Returns the last run's result, the events (each failure
        with its resume step, survivors and plan, then ``finished``) and
        the number of restarts."""
        fail_at = list(fail_at_steps or [])
        survivors = self.n_workers
        restarts = 0
        while True:
            inject = fail_at.pop(0) if fail_at else None
            try:
                out = run_training(self.cfg, fail_at_step=inject, **self.kw)
            except InjectedFailure as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                survivors = max(survivors - 1, 1)
                ck = latest_step(self.ckpt_dir)
                remaining = self.kw["steps"] - (ck or 0)
                plan = plan_restart(remaining, 1.0, self.n_workers,
                                    survivors, self.repair_time_s,
                                    device=self.device)
                self.events.append({
                    "kind": "failure", "error": str(e), "resume_step": ck,
                    "survivors": survivors, "plan": dataclasses.asdict(plan),
                })
                print(f"[elastic] failure ({e}); resume from step {ck} on "
                      f"{survivors} workers (plan: {plan.choice})",
                      flush=True)
                continue
            self.events.append({"kind": "finished",
                                "final_loss": out["final_loss"]})
            return {"result": out, "events": self.events,
                    "restarts": restarts}
