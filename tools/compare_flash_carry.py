"""Hold the checkout's ``flash_carry`` kernel against another source of it.

    python3 tools/compare_flash_carry.py OTHER.cu [--out FILE]

Builds ``OTHER.cu`` (for example the parent commit's
``src/repro_torch/csrc/flash_carry.cu``, unpacked with ``git archive``)
with the same ``nvcc`` flags into ``build/`` beside the checkout's source,
runs both at every ``flash_carry`` case of ``chip_smoke.py``'s phase 2 and
prints one JSON line per case: whether the two give the same bits (m, l
and the output), the largest difference, and each one's device time under
``torch.profiler``, taken in the order other, this, this, other. ``--out``
also writes the lines to FILE. Needs one CUDA GPU and ``nvcc``; exits 1
when no case could be run.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main(argv: list[str]) -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk

    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    out = Path(argv[argv.index("--out") + 1]) if "--out" in argv else None
    this = fk.FLASH_CARRY
    other = _build.Kernel("flash_carry", this.signatures)
    other.source = Path(argv[0]).resolve()
    _build.build_all((this, other))
    libs = {"this": this.lib(), "other": other.lib()}
    dev = torch.device("cuda")
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
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if lines else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
