"""Continuous-batching decode loop with live mid-generation resizes.

The port of ``repro/serve/loop.py``. Wave-granularity continuous batching:
at each wave start, free slots admit queued requests FIFO
(``plan_admission``); the wave shares one prefill and one scalar decode
position. Requests that finish early release their slot for the NEXT wave
while the batch keeps decoding; their rows' outputs are ignored.

Resize events from the elasticity trace (``core/events.ResizeEvent``,
replayed on a virtual clock) trigger Prepare in the background; the commit
lands at the next decode-step boundary — the cut. Requests decode on the
old world up to the cut and continue token-for-token on the new one,
because the migrated cache and params are byte-identical and greedy decode
is deterministic. Decode runs under ``torch.inference_mode()``; the greedy
token goes to the host once per step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.events import ResizeEvent, sort_trace
from repro_torch.serve.controller import LiveServeController
from repro_torch.serve.slots import RequestQueue, SlotAllocator, plan_admission

__all__ = ["ServeMetrics", "ServeSession"]


@dataclass
class ServeMetrics:
    tokens_emitted: int = 0
    wall_s: float = 0.0
    goodput_tok_s: float = 0.0
    p99_stall_s: float = 0.0
    max_stall_s: float = 0.0
    dropped: int = 0
    waves: int = 0
    commits: int = 0
    requests_served: int = 0
    stalls_s: list = field(default_factory=list)


def _p99(xs: list) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(np.ceil(0.99 * len(s))) - 1)]


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """(n, 1) int64 argmax of the last position, on the host."""
    return logits[:, -1].argmax(dim=-1, keepdim=True).cpu().numpy()


class ServeSession:
    """Drives the controller's active world over a request stream + trace.

    ``step_time_s > 0`` advances the virtual clock by a fixed amount per
    decode step (deterministic replay: a trace time maps to an exact cut
    step); ``0`` uses wall time × ``time_scale``.
    """

    def __init__(self, controller: LiveServeController, time_scale: float = 1.0, step_time_s: float = 0.0):
        self.ctrl = controller
        self.queue = RequestQueue()
        self.slots = SlotAllocator(controller.n_slots)
        self.time_scale = time_scale
        self.step_time_s = step_time_s
        self.clock = 0.0
        self.global_step = 0  # decode steps across all waves (cut_step unit)
        self._t0 = 0.0

    def submit(self, prompt, max_new_tokens: int):
        return self.queue.submit(prompt, max_new_tokens, now_s=self.clock)

    # -- event replay ---------------------------------------------------
    def _fire_due(self, events: list, ei: int) -> int:
        while ei < len(events) and self.clock >= events[ei].time_s:
            self.ctrl.request_resize(events[ei].target)
            ei += 1
        return ei

    def _tick(self) -> None:
        if self.step_time_s > 0:
            self.clock += self.step_time_s
        else:
            self.clock = (time.perf_counter() - self._t0) * self.time_scale

    def _assemble_batch(self, wave) -> dict:
        n, plen = self.ctrl.n_slots, self.ctrl.prompt_len
        tokens = np.zeros((n, plen), np.int64)
        for req in wave:
            if req.prompt.shape != (plen,):
                raise ValueError(f"prompt of shape {req.prompt.shape}, want ({plen},)")
            tokens[req.slot] = req.prompt
        return {"tokens": torch.from_numpy(tokens).to(self.ctrl.active.device)}

    def _emit(self, live, cur, results, metrics):
        """Record this step's token for every in-flight request; finished
        ones free their slot for the next wave's admission."""
        still = []
        for req in live:
            req.tokens.append(int(cur[req.slot, 0]))
            metrics.tokens_emitted += 1
            if len(req.tokens) >= req.max_new_tokens:
                req.finished = True
                results[req.rid] = req.tokens
                self.slots.free(req.slot)
            else:
                still.append(req)
        return still

    def _stall(self, metrics, t_last) -> float:
        now = time.perf_counter()
        metrics.stalls_s.append(now - t_last)
        return now

    # -- the loop -------------------------------------------------------
    def run(self, trace=()) -> tuple[dict, ServeMetrics]:
        """Serve until the queue drains. Returns ({rid: [token ids]},
        metrics); committed-resize records accrue on the controller."""
        events = [e for e in sort_trace(list(trace)) if isinstance(e, ResizeEvent)]
        ei = 0
        metrics = ServeMetrics()
        results: dict[int, list[int]] = {}
        self._t0 = time.perf_counter()
        t_last = self._t0

        with torch.inference_mode():
            while len(self.queue):
                # wave boundary: fire due events; a ready resize with no
                # generation in flight commits params-only (nothing to migrate)
                ei = self._fire_due(events, ei)
                if self.ctrl.resize_ready:
                    self.ctrl.commit(None, cut_step=self.global_step)
                    metrics.commits += 1
                wave = plan_admission(self.queue, self.slots, now_s=self.clock)
                metrics.waves += 1
                live = list(wave)
                batch = self._assemble_batch(wave)

                # prefill writes the prompt into the cache; its last-token
                # logits are the wave's first emission
                logits, cache, _ = self.ctrl.active.update_fn(self.ctrl.params, batch)
                cur = _greedy(logits)
                live = self._emit(live, cur, results, metrics)
                t_last = self._stall(metrics, t_last)
                self.global_step += 1

                step_in_wave = 0
                while live:
                    self._tick()
                    ei = self._fire_due(events, ei)
                    if self.ctrl.resize_ready:
                        # the cut: old world decoded up to here, the new world
                        # continues this very wave token-for-token
                        cache = self.ctrl.commit(cache, cut_step=self.global_step)
                        metrics.commits += 1
                    pos = self.ctrl.prompt_len + step_in_wave
                    tokens = torch.from_numpy(cur).to(self.ctrl.active.device)
                    logits, cache = self.ctrl.active.step_fn(self.ctrl.params, cache, tokens, pos)
                    cur = _greedy(logits)
                    live = self._emit(live, cur, results, metrics)
                    t_last = self._stall(metrics, t_last)
                    step_in_wave += 1
                    self.global_step += 1

        metrics.wall_s = time.perf_counter() - self._t0
        metrics.goodput_tok_s = metrics.tokens_emitted / metrics.wall_s if metrics.wall_s > 0 else 0.0
        metrics.p99_stall_s = _p99(metrics.stalls_s)
        metrics.max_stall_s = max(metrics.stalls_s, default=0.0)
        metrics.dropped = self.slots.evictions
        metrics.requests_served = len(results)
        return results, metrics
