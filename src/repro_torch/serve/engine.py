"""LM continuous batching (the port of ``repro/serve/engine.py``'s
``ServeEngine``).

A fixed array of slots; each holds one request's KV rows and current
length.  Each engine step decodes every slot in one ``decode_step`` (K4
on the card); finished slots (EOS, budget or ``max_seq``) are refilled from
the queue through ``prefill`` into the slot's cache rows.  Greedy decoding,
``torch.argmax`` taking the first index of a tie as ``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import LM, decode_step, init_cache, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] token ids
    max_new_tokens: int = 32
    generated: Optional[List[int]] = None


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens_generated: int = 0
    requests_completed: int = 0


class ServeEngine:
    def __init__(self, model: LM, batch_slots: int, max_seq: int, eos_id: int = -1):
        self.model = model
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.cache = init_cache(model.cfg, batch_slots, max_seq, device=model.device)
        self.lengths = np.zeros(batch_slots, np.int32)
        self.last_tokens = np.zeros(batch_slots, np.int32)
        self.budget = np.zeros(batch_slots, np.int32)       # remaining new tokens
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: Deque[Request] = deque()
        self.stats = EngineStats()

    # -- request management ---------------------------------------------------

    def submit(self, req: Request):
        req.generated = []
        self.queue.append(req)

    def _prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Prefill ``prompt`` into slot ``slot``'s cache rows; returns the
        first generated token."""
        tokens = torch.as_tensor(prompt, device=self.model.device)[None, :]
        logits, pcache = prefill(self.model, tokens, max_seq=self.max_seq)
        for key in ("k", "v"):
            self.cache[key][:, slot] = pcache[key][:, 0]
        return int(torch.argmax(logits[0]))

    def _fill_slots(self):
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            while self.queue:
                req = self.queue.popleft()
                if req.max_new_tokens <= 0:
                    # zero-budget request: completes with no tokens — it
                    # never even prefills, and the slot stays free
                    self.stats.requests_completed += 1
                    continue
                tok = self._prefill(s, req.prompt)
                req.generated.append(tok)
                self.stats.tokens_generated += 1  # first token (from prefill)
                if req.max_new_tokens == 1:
                    # the prefill token is the whole budget: finish at fill
                    # time, leaving the slot free for the next request
                    self.stats.requests_completed += 1
                    continue
                self.active[s] = req
                self.lengths[s] = len(req.prompt)
                self.last_tokens[s] = tok
                self.budget[s] = req.max_new_tokens - 1
                break

    # -- engine loop ------------------------------------------------------------

    def _decode(self) -> np.ndarray:
        """One ``decode_step`` over every slot; the next token of each."""
        dev = self.model.device
        tokens = torch.tensor(self.last_tokens, device=dev)
        lengths = torch.tensor(self.lengths, device=dev)
        logits, self.cache = decode_step(self.model, self.cache, tokens, lengths)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def step(self) -> int:
        """One decode step over all active slots; returns #active."""
        self._fill_slots()
        active_mask = np.array([r is not None for r in self.active])
        if not active_mask.any():
            return 0
        next_tokens = self._decode()

        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            tok = int(next_tokens[s])
            req.generated.append(tok)
            self.lengths[s] += 1
            self.last_tokens[s] = tok
            self.budget[s] -= 1
            self.stats.tokens_generated += 1
            done = (
                tok == self.eos_id
                or self.budget[s] <= 0
                or self.lengths[s] >= self.max_seq - 1
            )
            if done:
                self.stats.requests_completed += 1
                self.active[s] = None
                self.lengths[s] = 0
        self.stats.steps += 1
        return int(active_mask.sum())

    def run(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.stats


__all__ = ["Request", "EngineStats", "ServeEngine"]
