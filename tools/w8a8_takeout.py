"""Take-out timings and tile sweep of W8A8's int8 product (Q2,
``vit_torch_tpu_torch/csrc/w8a8.cu``) on one H100.

What a kernel's time is spent on shows when parts of its work are taken
out.  This script copies ``w8a8.cu`` into ``build/takeout/``, makes
variants of the copy by text substitution (the products, the stores, the
staging into the slices, the rescale or the whole epilogue taken out; the
program itself has no switch for this), builds each with the port's
``nvcc`` flags, and times each at the dino_vitb8 @224 bs32 products and
the Swin MLP shapes that W8A8 runs at bs8, on CUDA events and by the
profiler's device time, in turns (every variant, then every variant in
reverse).  The kernel as built is also timed at every tile the plan may
choose and with a ring one stage shorter, beside the bf16 ``F.linear`` of
the same product.

``--first PATH`` adds the source before the TMA-store epilogue (direct
stores from registers, 128-row tiles: ``w8a8.cu`` as of commit b01018d,
e.g. from ``git archive``) and its take-outs to the same turns.  The
substitutions match the text of those two sources: after an edit to the
kernel, bring them up to date (the script stops on one it does not find
exactly once).  The timings run in a child process with a time limit, so
that a variant that hangs ends the child and not the run.

    python3 tools/w8a8_takeout.py [--first PATH] [--out FILE]

Prints one JSON object a measurement and writes the same lines to
``--out`` (default ``build/takeout/results.jsonl``).  Needs a CUDA card
and ``nvcc``; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vit_torch_tpu_torch.ops import _build  # noqa: E402

WORK = ROOT / "build" / "takeout"
# dino_vitb8 @224 bs32 (785 tokens): qkv, proj, fc1, fc2; the Swin MLPs
# that W8A8 runs at bs8: stage 1's fc1 (a single k-step) and fc2, stage
# 4's fc1; Faster R-CNN's box_fc1 at bs8 x 256 RoIs
SHAPES = [(25120, 768, 2304), (25120, 768, 768), (25120, 768, 3072),
          (25120, 3072, 768), (73728, 128, 512), (73728, 512, 128),
          (1152, 1024, 4096), (2048, 12544, 1024)]
TILES = [(192, 192), (192, 128), (128, 192), (128, 128)]

# (variant, [(text, replacement), ...]); each text must occur once
NEVER = "p.K < 0"   # a runtime condition the compiler cannot fold
# the end of a tile's products, where the epilogue starts
FENCED = ("      sm90::fence_regs(acc);\n"
          "      if (lane == 0) sm90::mbar_arrive(empty + prev);\n")
RESCALE = ("  const float y = __fmul_rn(__fmul_rn(__int2float_rn("
           "static_cast<int>(acc)),\n"
           "                                      xs), ws);\n"
           "  return has_bias ? __fadd_rn(y, b) : y;\n")
STAGE = "        stage_slice<BN, OutT>(c, slice, acc, wsb, xs0, xs1, has_bias, t);\n"
VARIANTS = {
    "current": [
        ("full", []),
        ("no_store", [("        if (t == 0 && mw < p.T) {",
                       f"        if (t == 0 && mw < p.T && {NEVER}) {{")]),
        ("no_epilogue", [(FENCED, FENCED + f"      if (!({NEVER})) continue;\n")]),
        ("no_wgmma", [("    uint32_t acc[BN / 2];", "    uint32_t acc[BN / 2] = {};"),
                      ("          sm90::WgmmaS8<BN>::mma(acc, da + 2 * k, db + 2 * k,\n"
                       "                                 (kk | k) != 0);",
                       "          (void)da; (void)db;")]),
        # the epilogue's parts: its arithmetic (a move in place of the
        # conversion, the products and the bias), its staging into the
        # slices
        ("no_rescale", [(RESCALE, "  return __int_as_float(acc);\n")]),
        ("no_stage", [(STAGE, "")]),
    ],
    "first": [
        ("full", []),
        ("no_scale_loads", [
            ("        const float2 ws = __ldg(reinterpret_cast<const float2*>(\n"
             "            p.w_scale + col));",
             "        const float2 ws = make_float2(p.T, p.N);"),
            ("        const float2 b = has_bias ? __ldg(reinterpret_cast<const float2*>(\n"
             "                                        p.bias + col))\n"
             "                                  : make_float2(0.f, 0.f);",
             "        const float2 b = make_float2(p.K, p.T);")]),
        ("no_store", [("          const long long off = static_cast<long long>(row) * p.N + col;",
                       "          if ((__float_as_uint(v0) ^ __float_as_uint(v1)) != 0x7fc00001u)"
                       " continue;\n"
                       "          const long long off = static_cast<long long>(row) * p.N + col;")]),
        ("no_epilogue", [(FENCED, FENCED + f"      if (!({NEVER})) continue;\n")]),
        ("no_wgmma", [("    uint32_t acc[BN / 2];", "    uint32_t acc[BN / 2] = {};"),
                      ("          sm90::WgmmaS8<BN>::mma(acc, da + 2 * k, db + 2 * k,\n"
                       "                                 (kk | k) != 0);",
                       "          (void)da; (void)db;")]),
    ],
}
# products and epilogue both taken out: the loads alone
for _vs in VARIANTS.values():
    _vs.append(("loads_only", dict(_vs)["no_wgmma"] + dict(_vs)["no_epilogue"]))


def emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def variant_source(src: str, subs) -> str:
    for text, repl in subs:
        if src.count(text) != 1:
            raise SystemExit(f"substitution not found once: {text[:70]!r}")
        src = src.replace(text, repl)
    return src


def build_all(sources):
    """Compile every (layout, variant) library, all nvcc processes at
    once; returns {(layout, variant): path}."""
    WORK.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for layout, path in sources.items():
        src = Path(path).read_text()
        for name, subs in VARIANTS[layout]:
            cu = WORK / f"{layout}_{name}.cu"
            cu.write_text(variant_source(src, subs))
            lib = WORK / f"lib{layout}_{name}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                   str(lib), str(cu)]
            procs[(layout, name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln
                or "Performance Loss" in ln]
        yield key, str(lib), regs


def first_plan(T, K, N, sms):
    """The first design's plan (128-row tiles; the width of 192 / 128 whose
    busiest SM computes the fewest columns; stages that fit beside 1 KB
    and the barriers)."""
    tiles_m = -(-T // 128)

    def load(bn):
        return -(-(tiles_m * -(-N // bn)) // sms) * bn

    bn = min((192, 128), key=lambda b: (load(b), -b))
    stages = min(8, (232448 - 1024 - 128) // ((128 + bn) * 128))
    return bn, stages, min(tiles_m * -(-N // bn), sms)


def operands(T, K, N, seed, torch):
    from vit_torch_tpu_torch.ops import quant
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((T, K), generator=gen) * torch.exp(
        torch.randn((T, 1), generator=gen))).cuda().bfloat16()
    w = (0.03 * torch.randn((N, K), generator=gen)).cuda()
    b = (0.1 * torch.randn((N,), generator=gen)).cuda()
    x_q, x_s = quant.quantize_rowwise(x)
    w_q, w_s = quant.quantize_weight(w)
    return x, w, b, x_q, x_s.view(-1), w_q, w_s


def caller(layout, lib_path, T, K, N, tile, stages, torch):
    """A function (x_q, x_s, w_q, w_s, b, y, bf16) -> None that launches
    the library's w8a8_gemm with the given plan."""
    lib = ctypes.CDLL(lib_path)
    ints = 7 if layout == "first" else 8
    lib.w8a8_gemm.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * ints
                              + [ctypes.c_void_p])
    lib.w8a8_gemm.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if layout != "first":
        bm, bn = tile
        grid = min(-(-T // bm) * -(-N // bn), sms)
        plan = (bm, bn, stages, grid)
    else:
        plan = first_plan(T, K, N, sms)

    def run(x_q, x_s, w_q, w_s, b, y, bf16):
        err = lib.w8a8_gemm(x_q.data_ptr(), w_q.data_ptr(), x_s.data_ptr(),
                            w_s.data_ptr(), 0 if b is None else b.data_ptr(),
                            y.data_ptr(), int(bf16), T, K, N, *plan,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"w8a8_gemm returned {err} for plan {plan}")
    return run, plan


def device_ms(fn, torch, iters=10):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if "w8a8_gemm_kernel" in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n if n else None


def events_ms(fn, torch, iters=20):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def time_variants(libs, out, layouts):
    """Every variant of each layout at every shape, in turns; then the
    tree's kernel at every tile, the plan's choice and F.linear."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import quant
    for i, (T, K, N) in enumerate(SHAPES):
        x, w, b, x_q, x_s, w_q, w_s = operands(T, K, N, i, torch)
        y = torch.empty((T, N), dtype=torch.bfloat16, device="cuda")
        plan = quant.int8_plan(T, K, N)
        runs = []
        for layout in layouts:
            for name, _ in VARIANTS[layout]:
                tile = (plan.block_m, plan.block_n)
                run, used = caller(layout, libs[(layout, name)], T, K, N,
                                   tile, plan.stages, torch)
                runs.append(((layout, name, used), lambda r=run: r(
                    x_q, x_s, w_q, w_s, b, y, True)))
        lib = libs[("current", "full")]
        chosen = (plan.block_m, plan.block_n)
        for tile in TILES:
            if tile == chosen:
                continue
            bm, bn = tile
            stages = min(8, (232448 - quant.int8_smem_bytes(bm, bn, 0))
                         // ((bm + bn) * 128))
            run, used = caller("current", lib, T, K, N, tile, stages,
                               torch)
            runs.append((("current", "tile", used), lambda r=run: r(
                x_q, x_s, w_q, w_s, b, y, True)))
        if plan.stages > 2:   # the ring one stage shorter
            run, used = caller("current", lib, T, K, N, chosen,
                               plan.stages - 1, torch)
            runs.append((("current", "stages-1", used), lambda r=run: r(
                x_q, x_s, w_q, w_s, b, y, True)))
        wb, bb = w.bfloat16(), b.bfloat16()
        times = {key: [] for key, _ in runs}
        for order in (runs, runs[::-1]):
            for key, fn in order:
                times[key].append((events_ms(fn, torch),
                                   device_ms(fn, torch)))
        lin = [events_ms(lambda: F.linear(x, wb, bb), torch) for _ in (0, 1)]
        for (layout, name, used), ts in times.items():
            emit(out, {"shape": [T, K, N], "layout": layout,
                       "variant": name, "plan": list(used),
                       "ms": [t[0] for t in ts],
                       "device_ms": [t[1] for t in ts],
                       "chosen": layout == "current" and name != "tile"
                       and name != "stages-1"})
        emit(out, {"shape": [T, K, N], "bf16_linear_ms": lin,
                   "plan": plan._asdict()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first", help="the w8a8.cu before the TMA-store "
                    "epilogue, timed in turns with the tree's")
    ap.add_argument("--out", default=str(WORK / "results.jsonl"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    libs_file = WORK / "libs.json"
    layouts = ["first"] * bool(args.first) + ["current"]
    if args.child:   # the libraries are built
        libs = {tuple(k.split("/")): v for k, v in
                json.loads(libs_file.read_text()).items()}
        time_variants(libs, args.out, layouts)
        return 0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    sources = {"current": _build.CSRC / "w8a8.cu"}
    if args.first:
        sources["first"] = args.first
    t0 = time.perf_counter()
    libs = {}
    for key, lib, regs in build_all(sources):
        libs[key] = lib
        emit(args.out, {"built": "/".join(key), "ptxas": regs})
    emit(args.out, {"build_s": time.perf_counter() - t0,
                    "device": torch.cuda.get_device_name(0),
                    "smi": subprocess.run(
                        ["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()})
    libs_file.write_text(json.dumps({"/".join(k): v for k, v in
                                     libs.items()}))
    cmd = [sys.executable, __file__, "--child", "--out", args.out]
    if args.first:
        cmd += ["--first", args.first]
    try:
        rc = subprocess.run(cmd, timeout=600).returncode
    except subprocess.TimeoutExpired:
        rc = "timeout"
    emit(args.out, {"timings": layouts, "rc": rc})
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
