"""Batcher: task strings -> fixed-shape token batches.

Layout per example:  [BOS | prompt | answer | EOS | PAD…]  with a
``maskable`` indicator over the answer region (the diffusion corruption and
the loss touch only answer tokens — prompts are conditioning).
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.data.tasks import TASKS, task_geometry
from repro_torch.data.tokenizer import CharTokenizer


class TaskDataset:
    def __init__(self, task: str, tokenizer: CharTokenizer,
                 seq_len: int = 0, seed: int = 0):
        self.task = task
        self.tok = tokenizer
        self.gen = TASKS[task]
        self.prompt_len, self.answer_len = task_geometry(task)
        # [BOS prompt][answer EOS] — fixed geometry
        need = 1 + self.prompt_len + self.answer_len + 1
        self.seq_len = seq_len or need
        assert self.seq_len >= need, (self.seq_len, need)
        self.seed = seed

    @property
    def answer_slice(self) -> slice:
        lo = 1 + self.prompt_len
        return slice(lo, lo + self.answer_len)

    def encode_example(self, prompt: str, answer: str
                       ) -> Tuple[np.ndarray, np.ndarray]:
        t = self.tok
        ids = [t.bos] + t.encode(prompt) + t.encode(answer) + [t.eos]
        ids = t.pad_to(ids, self.seq_len)
        maskable = np.zeros(self.seq_len, bool)
        # the whole tail (answer + EOS + padding) is generation territory so
        # the model also learns to emit EOS/PAD at inference time
        maskable[self.answer_slice.start:] = True
        return np.asarray(ids, np.int32), maskable

    def batches(self, batch_size: int, seed: int = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed if seed is None else seed)
        while True:
            toks, masks, answers = [], [], []
            for _ in range(batch_size):
                p, a = self.gen(rng)
                ids, maskable = self.encode_example(p, a)
                toks.append(ids)
                masks.append(maskable)
                answers.append(a)
            yield {"tokens": np.stack(toks), "maskable": np.stack(masks),
                   "answers": answers}

    def eval_batch(self, batch_size: int, seed: int = 10_000
                   ) -> Dict[str, np.ndarray]:
        """A held-out batch (disjoint seed stream from training)."""
        return next(self.batches(batch_size, seed=seed))

    def prompts_only(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """[BOS prompt] prefix for inference-time generation."""
        return batch["tokens"][:, : 1 + self.prompt_len]

    def exact_match(self, generated: np.ndarray,
                    batch: Dict[str, np.ndarray]) -> float:
        """Fraction of examples whose decoded answer region matches."""
        sl = self.answer_slice
        want = batch["tokens"][:, sl]
        got = np.asarray(generated)[:, sl]
        return float(np.mean(np.all(want == got, axis=1)))
