"""``prefill``: a closed loop of one client; each call a batch of prompts
through ``make_prefill_step``, done when the argmax of each prompt's
last-position logits (its first token) is on the host. A call's latency
is the host's clock from dispatch to then.

Once the window has closed, the reference computes the last-position
logits of ``check_calls`` of the window's calls, drawn from the seed, and
the check reads how far below the reference's best logit each served
token's lies.
"""
from __future__ import annotations

import random
import time

import torch

from perfbench.lib import check, drive, feed, weights

ENTRY = ("repro_torch.train.step", "make_prefill_step")


def model_flops(body: int, head: int, traffic: dict) -> float:
    """The body at every prompt token, the head at each prompt's last
    position."""
    b, s = traffic["batch"], traffic["seq"]
    return 2.0 * (body * b * s + head * b)


def _half_batch(step):
    """Every row is served the first half's tokens."""
    def broken(params, batch):
        got = step(params, {k: v[: v.shape[0] // 2]
                            for k, v in batch.items()})
        return got.repeat(2, 1)[: batch["tokens"].shape[0]]
    return broken


def _token(step):
    """The first prompt's served token altered where it is produced (its
    logits rolled by one place)."""
    def broken(params, batch):
        got = step(params, batch).clone()
        got[0] = got[0].roll(1)
        return got
    return broken


FAULTS = {"half_batch": _half_batch, "token": _token}


class Kind:
    def __init__(self, cell, seed: int, dev):
        from repro_torch.train import step
        self.cell, self.seed, self.dev = cell, seed, dev
        self.cfg = cell.model_config()
        self.tokens = feed.token_pool(cell.traffic, self.cfg.vocab_size,
                                      seed, dev)
        self.params = weights.make(self.cfg, seed, dev)
        self.prefill_step = step.make_prefill_step(self.cfg, cell.n_pe)
        self.i = 0
        self.served = []          # (pool slot, ids, seconds) a call

    def call(self):
        k = self.i % self.tokens.shape[0]
        t0 = time.perf_counter()
        logits = self.prefill_step(self.params, {"tokens": self.tokens[k]})
        ids = logits.argmax(-1).cpu()
        self.served.append((k, ids, time.perf_counter() - t0))
        self.i += 1

    def setup(self) -> None:
        for _ in range(self.cell.traffic["setup_calls"]):
            self.call()
        self.served.clear()

    def end_to_end(self, calls: int, window_s: float) -> dict:
        b, s = self.tokens.shape[1:]
        lat = sorted(1e3 * dt for _, _, dt in self.served)
        p95 = lat[max(0, -(-95 * len(lat) // 100) - 1)]   # nearest rank
        return {"prefill_tokens_per_s": calls * b * s / window_s,
                "prefill_p95_ms": p95}

    def release(self) -> None:
        del self.params, self.prefill_step

    def sample(self) -> list:
        """The window's calls the check reads: ``check_calls`` of them,
        drawn from the seed (every prompt is as long as the longest)."""
        rng = random.Random(weights.derive(self.seed, "sample"))
        k = min(self.cell.traffic["check_calls"], len(self.served))
        return sorted(rng.sample(range(len(self.served)), k))

    def reference_logits(self, params, calls, precision: str):
        """[rows, V] last-position logits of the reference over the
        sampled calls' prompts, ``check_batch`` prompts at a time."""
        model = drive.reference_model(self.cell)
        prompts = torch.cat([self.tokens[self.served[c][0]] for c in calls])
        step = self.cell.traffic["check_batch"]
        with torch.no_grad():
            return torch.cat([model.last_logits(
                params, prompts[i:i + step], self.cell.config["model"],
                precision) for i in range(0, len(prompts), step)])

    def check(self) -> dict:
        self.calls = self.sample()
        self.params32 = drive.fp32_params(self.cell, self.seed, self.dev)
        self.ref = self.reference_logits(self.params32, self.calls, "fp32")
        served = torch.cat([self.served[c][1] for c in self.calls])
        gaps = check.logit_gaps(self.ref, served)
        return {"logit_gap": max(gaps), "where": {"tokens": len(gaps)}}

    def control(self) -> dict:
        """The tokens the reference computed a precision below the
        configuration's puts first, read in the fp32 reference's logits."""
        low = self.reference_logits(self.params32, self.calls, "fp8")
        gaps = check.logit_gaps(self.ref, low.argmax(-1))
        return {"logit_gap": max(gaps), "where": {"tokens": len(gaps)}}
