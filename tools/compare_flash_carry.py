"""Hold the checkout's ``flash_carry`` kernel, or its backward, against
another source of it.

    python3 tools/compare_flash_carry.py OTHER.cu [--out FILE]
    python3 tools/compare_flash_carry.py --backward OTHER.cu [--out FILE]

Builds ``OTHER.cu`` (for example the parent commit's
``src/repro_torch/csrc/flash_carry.cu``, unpacked with ``git archive``)
with the same ``nvcc`` flags into ``build/`` beside the checkout's source,
runs both at every ``flash_carry`` case of ``chip_smoke.py``'s phase 2 and
prints one JSON line per case: whether the two give the same bits (m, l
and the output), the largest difference, and each one's device time under
``torch.profiler``, taken in the order other, this, this, other.

With ``--backward``, ``OTHER.cu`` is a ``flash_carry_bwd.cu`` and the two
run at every case of phase 2's ``BWD_CASES``: per case, each one's largest
error against the closed-form twin (``flash_carry_backward_plain``) beside
its bound (the largest of error / bound over the six gradients), whether
both are within it, and each one's device time in the order other, this,
this, other. A source without pass B's split (the first form, whose C entry
takes no split arguments) runs unsplit.

``--out`` also writes the lines to FILE. Needs one CUDA GPU and ``nvcc``;
exits 1 when no case could be run.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


class _Unsplit:
    """A backward library without pass B's split, behind the checkout's C
    interface: the split arguments (nsplit, shares, partials: the three
    before the stream) are dropped, and it reports no resident blocks, so
    that the wrapper's plan is unsplit (every grid fills two waves of
    none)."""

    def __init__(self, lib):
        self._lib = lib
        self.flash_carry_bwd_uses_mma = lib.flash_carry_bwd_uses_mma

    def flash_carry_bwd(self, *args):
        return self._lib.flash_carry_bwd(*args[:-4], args[-1])

    @staticmethod
    def flash_carry_bwd_keys_resident(d, out):
        out._obj.value = 0
        return 0


def _forward(torch, fk, other_src, dev):
    this = fk.FLASH_CARRY
    other = cs_kernel(this, other_src)
    libs = {"this": this.lib(), "other": other.lib()}
    lines = []
    try:
        for name, case in cs.flash_cases(torch, fk, dev).items():
            args, opts = case["args"], case["opts"]
            outs, ms = {}, {"this": [], "other": []}
            for which in ("other", "this", "this", "other"):
                this._lib = libs[which]
                outs[which] = fk.flash_carry_cuda(*args, **opts)
                ms[which].append(cs.time_ms(
                    lambda: fk.flash_carry_cuda(*args, **opts),
                    only="flash_carry_kernel"))
            got, want = outs["this"], outs["other"]
            rec = {"case": name, "q": list(args[0].shape),
                   "dtype_q": str(args[0].dtype),
                   "same_bits": all(torch.equal(x, y)
                                    for x, y in zip(got, want)),
                   "max_abs_diff": cs.max_err(got, want),
                   "ms": ms["this"], "other_ms": ms["other"]}
            cs.log(json.dumps(rec))
            lines.append(rec)
            del outs, got, want
    finally:
        this._lib = libs["this"]
    return lines


def _backward(torch, fk, other_src, dev):
    from repro_torch.kernels import _build
    this = fk.FLASH_CARRY_BWD
    split = "flash_carry_bwd_keys_resident" in other_src.read_text()
    sigs = dict(this.signatures)
    if not split:
        entry = list(sigs["flash_carry_bwd"])
        sigs = {"flash_carry_bwd": entry[:-4] + entry[-1:],
                "flash_carry_bwd_uses_mma": sigs["flash_carry_bwd_uses_mma"]}
    other = _build.Kernel("flash_carry_bwd", sigs)
    other.source = other_src
    _build.build_all((fk.FLASH_CARRY, this, other))
    libs = {"this": this.lib(),
            "other": other.lib() if split else _Unsplit(other.lib())}
    for k in (this, other):
        for func, info in cs.ptxas_summary(k.ptxas_log):
            cs.log(f"[build] {k.source.name} ({'this' if k is this else 'other'}"
                   f"): {func}: {info}")
    cases = cs.flash_cases(torch, fk, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    lines = []
    try:
        for name in cs.BWD_CASES:
            args, opts, outs, ups = cs.bwd_case(torch, fk, cases, name, g)
            call = lambda: fk.flash_carry_backward_cuda(  # noqa: E731
                *args, *outs, *ups, **opts)
            want = fk.flash_carry_backward_plain(*args, *outs, *ups, **opts)
            rec = {"case": name, "q": list(args[0].shape),
                   "k": list(args[1].shape)}
            ms = {"this": [], "other": []}
            for which in ("other", "this", "this", "other"):
                this._lib = libs[which]
                fk._RESIDENT.clear()               # each library's own plan
                if which not in rec:
                    errs, tols, ok = cs.bwd_errors(torch, call(), want)
                    rec[which] = {
                        "max_abs_err": max(errs),
                        "of_bound": max(e / t if t else float(e > 0)
                                        for e, t in zip(errs, tols)),
                        "within": ok, "nsplit": fk.backward_split(
                            args[0], args[1])}
                ms[which].append(cs.time_ms(
                    call, iters=10, only="flash_carry_bwd_kernel"))
            rec["ms"], rec["other_ms"] = ms["this"], ms["other"]
            cs.log(json.dumps(rec))
            lines.append(rec)
            del outs, ups, want
    finally:
        this._lib = libs["this"]
        fk._RESIDENT.clear()
    return lines


def cs_kernel(this, source: Path):
    """A second build of ``this`` kernel's C interface from ``source``."""
    from repro_torch.kernels import _build
    other = _build.Kernel(this.name, this.signatures)
    other.source = source
    _build.build_all((this, other))
    return other


def main(argv: list[str]) -> int:
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk

    backward = "--backward" in argv
    rest = [a for a in argv if a != "--backward"]
    out = None
    if "--out" in rest:
        i = rest.index("--out")
        out = Path(rest[i + 1])
        del rest[i:i + 2]
    if len(rest) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.log(cs.gpu_name_and_limit())
    src = Path(rest[0]).resolve()
    lines = (_backward if backward else _forward)(torch, fk, src, dev)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if lines else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
