"""Request batching for the serving engine (paper gateway -> pod path)."""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np

_req_ids = itertools.count()


@dataclasses.dataclass
class InferenceRequest:
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    arrival: float = dataclasses.field(default_factory=time.monotonic)
    output: Optional[np.ndarray] = None
    completed_at: Optional[float] = None

    @property
    def latency(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.arrival


class Batcher:
    """Greedy size/timeout batcher with right-aligned prompt padding."""

    def __init__(self, max_batch: int, max_wait_s: float = 0.02,
                 pad_id: int = 0):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pad_id = pad_id
        self.queue: Deque[InferenceRequest] = deque()

    def submit(self, req: InferenceRequest) -> None:
        self.queue.append(req)

    def ready(self, now: Optional[float] = None) -> bool:
        if not self.queue:
            return False
        if len(self.queue) >= self.max_batch:
            return True
        now = now if now is not None else time.monotonic()
        return now - self.queue[0].arrival >= self.max_wait_s

    def next_batch(self) -> List[InferenceRequest]:
        take = min(self.max_batch, len(self.queue))
        return [self.queue.popleft() for _ in range(take)]

    @staticmethod
    def pad_prompts(reqs: List[InferenceRequest], pad_id: int = 0,
                    pad_to: Optional[int] = None) -> np.ndarray:
        """Left-pad to a common length so decode positions align.

        Args:
            reqs: non-empty list of requests.
            pad_id: fill token for the left padding.
            pad_to: fixed output width. None (the default) pads to the
                longest prompt in the batch; an explicit width must be
                >= 1, and prompts longer than it are truncated to their
                TRAILING ``pad_to`` tokens — with left padding the tail
                of the prompt is what sits next to the decode position.
        Returns: ``(len(reqs), L) int32`` array.
        Raises: ``ValueError`` for an empty batch or ``pad_to < 1``.
        """
        if not reqs:
            raise ValueError("pad_prompts: empty request list")
        if pad_to is None:
            L = max(len(r.prompt) for r in reqs)
        else:
            L = int(pad_to)
            if L < 1:
                raise ValueError(f"pad_prompts: pad_to={pad_to} must be "
                                 ">= 1 (or None to fit the batch)")
        out = np.full((len(reqs), L), pad_id, np.int32)
        for i, r in enumerate(reqs):
            p = r.prompt[-L:]   # keep the tail when truncating
            out[i, L - len(p):] = p
        return out
