"""Continuous-batching serving engine over the unified Model API.

The port of ``repro.serving.engine``.  Slots are rows of a shared batched KV
cache on ``device`` (the GPU by default); each engine step decodes one token
for every slot (idle slots compute and are ignored, so the batch shape is
static).  Prefill runs one request at a time into its slot.  The caches and
the ``tokens`` / ``pos`` tensors are updated in place.

Admission and preemption come from ``serving.scheduler`` (the CloudSim
policy), and ``choose_policy`` re-plans every ``replan_every`` steps by
simulating the live queue with the port's ``simulate`` on the same device.

Two behaviours of the reference are kept as they are: a request preempted
under time sharing re-prefills its prompt when it is re-admitted, and its
``generated`` count restarts at 1; and ``tokens_per_sec``, which feeds the
re-plan, comes from wall time, so re-planning is not deterministic across
runs.

Serving computes no gradients: ``step`` runs under ``torch.no_grad()``, so
the flash kernel's wrapper, which refuses autograd, serves parameters that
require a gradient too.

``stats`` counts the prefills and the prompt tokens they took, the decode
steps and the tokens they produced for live requests, and the seconds each
took (host clock, ending in a device synchronisation).
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.models.api import Model
from repro_torch.serving.scheduler import Request, SlotScheduler, choose_policy


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    def __init__(
        self,
        model: Model,
        params: Any,
        n_slots: int,
        max_len: int,
        policy: int = 0,
        quantum: int = 32,
        replan_every: int = 0,       # 0 = fixed policy
        eos_token: int = -1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model, self.params = model, params
        self.n_slots, self.max_len = n_slots, max_len
        self.sched = SlotScheduler(n_slots, policy, quantum)
        self.replan_every = replan_every
        self.eos = eos_token
        self.caches = model.init_caches(n_slots, max_len, self.device)
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.int64,
                                  device=self.device)
        self.pos = torch.zeros((n_slots,), dtype=torch.int64,
                               device=self.device)
        self.requests: list[Request] = []
        self.steps = 0
        self.tokens_per_sec = 100.0   # running estimate, feeds the simulator
        self.stats = {"prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_steps": 0, "decode_tokens": 0, "decode_s": 0.0}

    # ------------------------------------------------------------- intake
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> Request:
        r = Request(
            rid=len(self.requests),
            arrival=self.steps,
            prompt_len=len(prompt),
            max_new_tokens=max_new_tokens,
        )
        r.prompt = np.asarray(prompt, np.int64)      # type: ignore[attr-defined]
        self.requests.append(r)
        return r

    # ------------------------------------------------------------- internals
    def _prefill_into_slot(self, r: Request) -> None:
        t0 = time.perf_counter()
        prompt = torch.as_tensor(r.prompt, device=self.device)[None]  # [1, P]
        logits, cache = self.model.prefill(
            self.params, {"tokens": prompt}, self.max_len)
        slot = r.slot
        # write the single-request cache into the batched slot row
        for name, sub in cache.items():
            for kv, one in sub.items():
                self.caches[name][kv][:, slot:slot + 1].copy_(one)
        self.tokens[slot, 0] = logits[0].argmax()
        self.pos[slot] = r.prompt_len
        r.generated = 1
        _sync(self.device)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += r.prompt_len
        self.stats["prefill_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------- main loop
    @torch.no_grad()
    def step(self) -> dict:
        """One engine iteration: (re)plan, admit+prefill, decode one batched token."""
        if self.replan_every and self.steps % self.replan_every == 0:
            pol, _ = choose_policy(
                self.requests, self.n_slots, self.tokens_per_sec, self.device)
            self.sched.policy = pol

        for r in self.sched.assign(self.requests):
            self._prefill_into_slot(r)

        t0 = time.perf_counter()
        logits, self.caches = self.model.decode_step(
            self.params, self.caches, self.tokens, self.pos)
        nxt = logits.argmax(-1)
        nxt_host = nxt.tolist()          # waits for the device
        dt = max(time.perf_counter() - t0, 1e-6)

        active = [r for r in self.requests if r.slot >= 0 and not r.done]
        self.tokens_per_sec = 0.9 * self.tokens_per_sec + 0.1 * (
            max(len(active), 1) / dt
        )
        self.tokens[:, 0] = nxt
        self.pos += 1
        self.steps += 1
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(active)
        self.stats["decode_s"] += dt

        finished = []
        for r in active:
            r.generated += 1
            tok = nxt_host[r.slot]
            if r.generated >= r.max_new_tokens or tok == self.eos:
                r.done = True
                r.finish_time = self.steps
                r.slot = -1
                finished.append(r)
        return {
            "step": self.steps,
            "active": len(active),
            "finished": [r.rid for r in finished],
            "tokens_per_sec": self.tokens_per_sec,
        }

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        while any(not r.done for r in self.requests) and self.steps < max_steps:
            self.step()
        return self.requests
