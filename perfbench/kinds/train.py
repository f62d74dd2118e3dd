"""``train``: ``make_train_step`` on one batch after another.

The set-up steps run through the window's own call on the pool's first
rows; after the first, the program's gradient as the optimizer got it
(its first moment over 1 - beta1) is read, after ``check_steps`` the
parameters' change (of the fp32 masters step 4 starts from). Once the
window has closed, the reference follows those steps from the same
parameters on the same batches.
"""
from __future__ import annotations

import torch

from perfbench.lib import check, drive, feed, tree, weights

ENTRY = ("repro_torch.train.step", "make_train_step")


def model_flops(body: int, head: int, traffic: dict) -> float:
    """A step is 3 times its forward (forward, and the two products of
    each weight's backward), the head at every position; remat's
    recompute is not useful work and is not counted."""
    return 3 * 2.0 * (body + head) * traffic["batch"] * traffic["seq"]


def _norms(tensors) -> list:
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64)
                        for t in tensors]).tolist()


def _unchanged(step):
    return lambda state, batch: (state, step(state, batch)[1])


def _half_batch(step):
    """The step sees only the first half of each batch's rows (and takes
    the mean over them)."""
    def broken(state, batch):
        return step(state, {k: v[: v.shape[0] // 2]
                            for k, v in batch.items()})
    return broken


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}


class Kind:
    def __init__(self, cell, seed: int, dev):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.train import optimizer, step
        self.cell, self.seed, self.dev = cell, seed, dev
        tr = cell.traffic
        self.cfg = cell.model_config()
        self.tcfg = TrainConfig(**tr["optimizer"])
        pool = feed.token_pool(tr, self.cfg.vocab_size, seed, dev)
        self.tokens = pool[..., :-1].contiguous()
        self.targets = pool[..., 1:].contiguous()
        del pool
        params = weights.make(self.cfg, seed, dev)
        self.state = {"params": params,
                      "opt": optimizer.init_opt_state(params, self.tcfg)}
        self.train_step = step.make_train_step(self.cfg, self.tcfg,
                                               cell.n_pe)
        self.i = 0
        self.program = {}

    def batch(self, i: int) -> dict:
        k = i % self.tokens.shape[0]
        return {"tokens": self.tokens[k], "targets": self.targets[k]}

    def call(self):
        self.state, metrics = self.train_step(self.state, self.batch(self.i))
        self.i += 1
        drive.sync(self.dev)
        return metrics

    def _masters(self):
        return tree.leaves(self.state["opt"].get("master",
                                                 self.state["params"]))

    def setup(self) -> None:
        n = self.cell.traffic["check_steps"]
        start = [t for _, t in self._masters()]
        losses = []
        for k in range(self.cell.traffic["setup_calls"]):
            losses.append(self.call()["loss"])
            if k == 0:
                m = tree.leaves(self.state["opt"]["m"])
                self.program["grad"] = dict(zip(
                    [p for p, _ in m],
                    [x / (1.0 - self.tcfg.beta1)
                     for x in _norms([t for _, t in m])]))
            if k + 1 == n:
                now = self._masters()
                self.program["change"] = dict(zip(
                    [p for p, _ in now],
                    _norms([t - s for (_, t), s in zip(now, start)])))
                del start
        self.program["loss"] = [float(x) for x in losses[:n]]

    def end_to_end(self, calls: int, window_s: float) -> dict:
        b, s = self.tokens.shape[1:]
        return {"train_tokens_per_s": calls * b * s / window_s}

    def release(self) -> None:
        del self.state, self.train_step

    def reference(self, precision: str) -> dict:
        """The reference's first ``check_steps`` steps from the same
        parameters on the same batches."""
        from perfbench.reference import train as ref_train
        n = self.cell.traffic["check_steps"]
        params = drive.fp32_params(self.cell, self.seed, self.dev)
        batches = [(self.tokens[k], self.targets[k]) for k in range(n)]
        return ref_train.steps(drive.reference_model(self.cell), params,
                               batches, self.cell.config["model"],
                               self.cell.traffic["optimizer"], precision)

    def check(self) -> dict:
        self.ref = self.reference("fp32")
        out = check.train(self.program, self.ref)
        out["where"]["losses"] = [self.program["loss"], self.ref["loss"]]
        return out

    def control(self) -> dict:
        """The reference computed a precision below the configuration's,
        in the program's place."""
        self.low = self.reference("fp8")
        return check.train(self.low, self.ref)
