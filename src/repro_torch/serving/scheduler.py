"""CloudSim-driven continuous-batching scheduler (the paper as control plane).

The port of ``repro.serving.scheduler``.  Mapping (DESIGN.md §2): inference
**requests = Cloudlets**, **KV-cache slots = VMs**, **device group = Host**.
The two CloudSim policies become admission disciplines:

  * space-shared  — a request owns its slot until completion; excess requests
    queue (Figure 4a semantics at the slot level).
  * time-shared   — more requests than slots are multiplexed round-robin with
    a token quantum (Figure 4d semantics; preemption swaps the slot's cache).

``choose_policy`` builds a CloudSim scenario from the live queue (request
length -> cloudlet MI via the measured per-token cost) and simulates BOTH
policies with the port's ``simulate`` on ``device`` (the GPU by default, so
the re-plan runs the advance-sweep kernel), picking the lower expected mean
turnaround.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import (
    SPACE_SHARED,
    TIME_SHARED,
    Scenario,
    resolve_device,
    scenarios as builders,
    simulate,
)


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float          # engine step time (s)
    prompt_len: int
    max_new_tokens: int
    generated: int = 0
    slot: int = -1          # -1 = waiting
    done: bool = False
    finish_time: float = -1.0


def queue_scenario(
    requests: list[Request],
    n_slots: int,
    tokens_per_sec: float,
    vm_policy: int,
    device=None,
) -> Scenario:
    """Live queue -> CloudSim scenario on ``device``: slots are VMs on one
    host whose core count is the slot count; each pending/running request is
    a cloudlet whose remaining tokens convert to MI at 1 token = 1 MI, host
    speed = measured decode throughput (MI/s == tokens/s)."""
    dev = resolve_device(device)
    live = [r for r in requests if not r.done]
    n = max(len(live), 1)
    hosts = builders.uniform_hosts(
        1, 1, cores=n_slots, mips=tokens_per_sec, ram_mb=1e9, bw_mbps=1e9,
        device=dev,
    )
    vms = builders.uniform_vms(
        1, cores=n_slots, mips=tokens_per_sec, ram_mb=1.0, bw_mbps=1.0,
        device=dev,
    )
    remaining = np.array(
        [max(r.max_new_tokens - r.generated, 1) for r in live] or [1],
        np.float32,
    )
    submit = np.zeros(n, np.float32)
    cls = builders.make_cloudlets(
        np.zeros(n, np.int32), remaining, submit,
        input_mb=0.0, output_mb=0.0, device=dev,
    )
    pol = builders.make_policy(
        host_policy=SPACE_SHARED, vm_policy=vm_policy, horizon=1e7,
        device=dev,
    )
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=builders.uniform_market(1, device=dev), policy=pol)


def choose_policy(
    requests: list[Request], n_slots: int, tokens_per_sec: float,
    device=None,
) -> tuple[int, dict]:
    """Simulate the live queue under both policies; pick the better one.

    Returns (policy, {"space": metrics, "time": metrics}).  Preference:
    lower mean turnaround, tie-broken by makespan — the paper's Table-1
    metrics used as an online objective.
    """
    live = [r for r in requests if not r.done]
    if not live:
        return SPACE_SHARED, {}
    out = {}
    for name, pol in (("space", SPACE_SHARED), ("time", TIME_SHARED)):
        scn = queue_scenario(requests, n_slots, tokens_per_sec, pol, device)
        res = simulate(scn, device=device)
        out[name] = {
            "mean_tat": float(res.mean_turnaround),
            "makespan": float(res.makespan),
        }
    better = (
        SPACE_SHARED
        if out["space"]["mean_tat"] <= out["time"]["mean_tat"]
        else TIME_SHARED
    )
    return better, out


class SlotScheduler:
    """Slot assignment under a CloudSim policy (host-side, O(requests))."""

    def __init__(self, n_slots: int, policy: int = SPACE_SHARED,
                 quantum: int = 32):
        self.n_slots = n_slots
        self.policy = policy
        self.quantum = quantum          # decode steps between RR rotations
        self._rr_counter = 0

    def assign(self, requests: list[Request]) -> list[Request]:
        """Mutates slot assignments; returns requests newly (re)admitted."""
        free = set(range(self.n_slots)) - {
            r.slot for r in requests if r.slot >= 0 and not r.done
        }
        waiting = [r for r in requests if not r.done and r.slot < 0]
        admitted: list[Request] = []

        if self.policy == TIME_SHARED and waiting:
            self._rr_counter += 1
            if self._rr_counter >= self.quantum:
                self._rr_counter = 0
                running = sorted(
                    (r for r in requests if r.slot >= 0 and not r.done),
                    key=lambda r: r.generated, reverse=True,
                )
                # preempt the most-served request per rotation (swap out)
                if running:
                    victim = running[0]
                    free.add(victim.slot)
                    victim.slot = -1
                    waiting = [r for r in requests if not r.done and r.slot < 0]

        for r in sorted(waiting, key=lambda r: r.arrival):   # FCFS
            if not free:
                break
            r.slot = free.pop()
            admitted.append(r)
        return admitted
