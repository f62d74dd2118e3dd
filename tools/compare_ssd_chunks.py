"""Hold the checkout's ``ssd_chunks_bwd`` kernel against another source of
it.

    python3 tools/compare_ssd_chunks.py OTHER.cu [--ablate KIND]
        [--cases A,B] [--dtype bf16|fp32|both] [--out FILE]

Builds ``OTHER.cu`` (for example the parent commit's
``src/repro_torch/csrc/ssd_chunks_bwd.cu``, unpacked with ``git archive``)
with the same ``nvcc`` flags into ``build/`` beside the checkout's source,
runs both at every ``SSD_BWD_CASES`` case of ``chip_smoke.py``'s phase 2
(or those of ``--cases``) and prints one JSON line per case and dtype:
each one's largest error against the float64 oracle beside its bound (the
largest of error / bound over the five gradients), whether all five are
within it, each one's device time (order other, this, this, other) and
each one's time by kernel body.

``OTHER.cu`` may have either C entry: the first form's (per-head dB / dC
scratch [BH, NC, L, N] and a float64 da scratch [BH, NC], allocated here)
or the checkout's (its plan from ``kernels/ssd/kernel.py``).

``--ablate`` takes work out of ``OTHER.cu`` before building it, to see
what a pass waits on (its results are then wrong, and reported so):
``loads`` makes the first form's ``load_split`` (gy and gS read as fp32
and split into bf16 halves) fill zeros without reading; ``products``
makes ``mma_bf16`` issue no ``mma.sync`` (either form); for the
redesigned pass A, ``elementwise`` sets every decay to 0 (the
element-wise work of each tile pair folds away) and ``items`` keeps only
the items' loads, splits and barriers.

``--out`` also writes the lines to FILE. Needs one CUDA GPU and ``nvcc``;
exits 1 when no case could be run.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

# ablation: [(what is replaced, what replaces it)] in the source
ABLATIONS = {
    # the first form's split loads of gy and gS
    "loads": [("const float v = (r0 + r < L && c < W) ? "
               "src[(size_t)(r0 + r) * W + c] : 0.f;",
               "const float v = 0.f;")],
    # either form: no mma.sync issued
    "products": [('      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
                  '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
                  '{%0, %1, %2, %3};\\n"',
                  '      ""')],
    # the redesign: every decay 0, so the element-wise work folds away
    "elementwise": [("const float arg = t >= sr[e] && t < L ? "
                     "hc[t - s0] - cum_s[e]\n"
                     "                                                      : "
                     "__int_as_float(0xff800000);",
                     "const float arg = __int_as_float(0xff800000);")],
    # the redesign: pass A's items load, split and wait, and compute nothing
    "items": [("    if (it.kind == 0) {", "    if (it.kind == 0 && false) {"),
              ("    } else if (it.kind == 1) {",
               "    } else if (it.kind == 1 && false) {"),
              ("    } else if (it.kind == 2) {",
               "    } else if (it.kind == 2 && false) {"),
              ("    } else {\n      // ---- dB += dCB^T C_t",
               "    } else if (false) {\n      // ---- dB += dCB^T C_t")],
}


def _source(src: Path, ablate: str | None) -> Path:
    """``src``, or an ablated copy of it under ``build/``."""
    if ablate is None:
        return src
    text = src.read_text()
    for old, new in ABLATIONS[ablate]:
        if text.count(old) != 1:
            raise SystemExit(f"--ablate {ablate}: {src} has no single {old!r}")
        text = text.replace(old, new)
    out = ROOT / "build" / f"ssd_chunks_bwd_ablate_{ablate}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


class _FirstForm:
    """A library with the first form's C entry behind the wrapper's
    arguments: per-head dB / dC scratch and per-chunk da scratch."""

    def __init__(self, lib):
        self._lib = lib

    def call(self, torch, sk, args, ups, opts):
        from repro_torch.kernels._build import stream_handle
        x, dt, a, b, c = (t.contiguous() for t in args)
        gy, gs, ge = (u.float().contiguous() for u in ups)
        bh, nc, l, p = x.shape
        n = b.shape[-1]
        dev = x.device
        dx, ddt = torch.empty_like(x), torch.empty(bh, nc, l, 1, device=dev)
        da = torch.empty(bh, 1, 1, 1, device=dev)
        db, dc = torch.empty_like(b), torch.empty_like(c)
        db_part = torch.empty(bh, nc, l, n, device=dev)
        dc_part = torch.empty(bh, nc, l, n, device=dev)
        da_part = torch.empty(bh, nc, dtype=torch.float64, device=dev)
        err = self._lib.ssd_chunks_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), gy.data_ptr(), gs.data_ptr(), ge.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
            da_part.data_ptr(), bh, nc, l, p, n, opts["nheads"],
            opts["ngroups"], sk.DTYPE_CODES[x.dtype],
            stream_handle(dev))
        sk.SSD_CHUNKS_BWD.check(err)
        return dx, ddt, da, db, dc


class _ThisForm:
    """A library with the checkout's C entry, called by its wrapper."""

    def __init__(self, lib):
        self.lib = lib

    def call(self, torch, sk, args, ups, opts):
        this = sk.SSD_CHUNKS_BWD
        saved = this._lib
        this._lib = self.lib
        try:
            return sk.ssd_chunks_backward_cuda(*args, *ups, **opts)
        finally:
            this._lib = saved


def _other(sk, src: Path):
    """The other source built beside the checkout's, behind the call its C
    entry takes."""
    from repro_torch.kernels import _build
    first = "void* dc_part, void* da_part, int BH" in src.read_text()
    _P, _I = ctypes.c_void_p, ctypes.c_int
    sigs = {"ssd_chunks_bwd": [_P] * 16 + [_I] * 8 + [_P]} if first \
        else sk.SSD_CHUNKS_BWD.signatures
    other = _build.Kernel("ssd_chunks_bwd", sigs)
    other.source = src
    _build.build_all((sk.SSD_CHUNKS, sk.SSD_CHUNKS_BWD, other))
    for k, which in ((sk.SSD_CHUNKS_BWD, "this"), (other, "other")):
        for func, info in cs.ptxas_summary(k.ptxas_log):
            cs.log(f"[build] {k.source.name} ({which}): {func}: {info}")
    return (_FirstForm if first else _ThisForm)(other.lib())


def compare(torch, sk, other, cases, dtypes, dev):
    this = _ThisForm(sk.SSD_CHUNKS_BWD.lib())
    forms = {"this": this, "other": other}
    g = torch.Generator(device=dev).manual_seed(8)
    lines = []
    for case in cases:
        for dtype in dtypes:
            args, ups, opts = cs.ssd_bwd_case(torch, g, dev, dtype, case)
            want = cs.ssd_bwd_want(torch, sk, args, ups, opts)
            flops, moved, kind = sk.backward_work(*args, **opts)
            b_ms, b_by = cs.bound(moved, flops, kind)
            name = f"{case}_{'fp32' if dtype == torch.float32 else 'bf16'}"
            rec = {"case": name, "x": list(args[0].shape),
                   "b": list(args[3].shape), "bound_ms": b_ms,
                   "bound_by": b_by, "slices": sk.backward_slices(
                       args[0], args[3], **opts),
                   "resident": sk.backward_resident(args[0], args[3])}
            ms = {"this": [], "other": []}
            for which in ("other", "this", "this", "other"):
                form = forms[which]
                call = lambda form=form: form.call(  # noqa: E731
                    torch, sk, args, ups, opts)
                if which not in rec:
                    got = call()
                    torch.cuda.synchronize()
                    errs, tols, ok = cs.ssd_bwd_errors(torch, got, want)
                    rec[which] = {
                        "max_abs_err": max(errs),
                        "of_bound": max(e / t if t else float(e > 0)
                                        for e, t in zip(errs, tols)),
                        "within": ok,
                        "passes_ms": cs.split_ms(call, "ssd_bwd_")}
                    del got
                ms[which].append(cs.time_ms(call, iters=10, only="ssd_bwd_"))
            rec["ms"], rec["other_ms"] = ms["this"], ms["other"]
            cs.log(json.dumps(rec))
            lines.append(rec)
            del args, ups, want
    return lines


def main(argv: list[str]) -> int:
    import torch
    from repro_torch.kernels.ssd import kernel as sk

    opts = {"--ablate": None, "--cases": ",".join(cs.SSD_BWD_CASES),
            "--dtype": "both", "--out": None}
    rest = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it, None)
        else:
            rest.append(a)
    dtypes = {"bf16": [torch.bfloat16], "fp32": [torch.float32],
              "both": [torch.float32, torch.bfloat16]}.get(opts["--dtype"])
    cases = opts["--cases"].split(",")
    if len(rest) != 1 or dtypes is None or not torch.cuda.is_available() \
            or opts["--ablate"] not in (None, *ABLATIONS) \
            or any(c not in cs.SSD_CASES for c in cases):
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.log(cs.gpu_name_and_limit())
    src = _source(Path(rest[0]).resolve(), opts["--ablate"])
    lines = compare(torch, sk, _other(sk, src), cases, dtypes, dev)
    if opts["--out"] is not None:
        out = Path(opts["--out"])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if lines else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
