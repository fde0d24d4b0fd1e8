"""Take-out timings of W8A8's two kernels (``vit_torch_tpu_torch/csrc/
w8a8.cu``) on one H100: the row quantisation (Q1) with its plan sweep,
or the int8 product (Q2) with its tile sweep.

What a kernel's time is spent on shows when parts of its work are taken
out.  This script copies ``w8a8.cu`` into ``build/takeout/``, makes
variants of the copy by text substitution (the program itself has no
switch for this), builds each with the port's ``nvcc`` flags, and times
each on CUDA events and by the profiler's device time, in turns (every
variant, then every variant in reverse).

- ``--kernel q1`` (the default): the division taken out (a multiply in its
  place), the rounding, the code stores; at the dino_vitb8 @224 bs32 and
  bs8 inputs of qkv and fc2 (K = 768, 3072), Faster R-CNN's box head
  (2048 x 12,544 and 2048 x 1024), Swin bs8's stage-1 MLP inputs
  (73,728 x 128 and x 512), all bf16, and an fp32 weight (4096 x 1024).
  The kernel as built is also timed with each row spread over half and
  twice the plan's threads.
- ``--kernel q2``: the products, the stores, the staging into the slices,
  the rescale or the whole epilogue taken out, at the dino_vitb8 @224 bs32
  products and the Swin MLP shapes that W8A8 runs at bs8; the kernel as
  built also at every tile the plan may choose and with a ring one stage
  shorter, beside the bf16 ``F.linear`` of the same product.

``--first PATH`` adds the kernel's first design and its take-outs to the
same turns: for Q1 ``w8a8.cu`` as of commit 0db2191 (a warp a row, eight
rows a block, the row read twice; its extra take-out reads the row once,
making the codes from registers), for Q2 as of commit b01018d (direct
stores from registers, 128-row tiles), e.g. from ``git archive``.  The
substitutions match the text of those sources: after an edit to a
kernel, bring them up to date (the script stops on one it does not find
exactly once).  The timings run in a child process with a time limit, so
that a variant that hangs ends the child and not the run.

    python3 tools/w8a8_takeout.py [--kernel q1|q2] [--first PATH] [--out FILE]

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

# Q1's inputs (R, K, bytes a value): dino_vitb8 @224 bs32 and bs8 (785
# tokens) at K = 768 (qkv, fc1) and 3072 (fc2); the box head's box_fc1
# and box_fc2 at bs8 x 256 RoIs; swin_base_384 bs8 stage 1's fc1 and fc2;
# an fp32 weight (quantize_weight)
Q1_SHAPES = [(25120, 768, 2), (25120, 3072, 2), (6280, 768, 2),
             (6280, 3072, 2), (2048, 12544, 2), (2048, 1024, 2),
             (73728, 128, 2), (73728, 512, 2), (4096, 1024, 4)]

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
# Q1's arithmetic in each design
CODE = "  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);\n"
FIRST_CODE = "  const float q = rintf(__fdiv_rn(x, scale));\n"
FIRST_AMAX = ("    for (int i = 0; i < kE; ++i) amax = fmaxf(amax, "
              "fabsf(widen(e[i])));\n")
Q1_VARIANTS = {
    "current": [
        ("full", []),
        ("no_div", [(CODE, CODE.replace("__fdiv_rn", "__fmul_rn"))]),
        ("no_round", [(CODE, CODE.replace("rintf(__fdiv_rn(x, scale))",
                                          "__fdiv_rn(x, scale)"))]),
        # the codes still computed (a store they decide, never taken in
        # practice), none written
        ("no_store", [("    dst[u] = make_uint4(out[0], out[1], out[2], out[3]);",
                       "    if ((out[0] ^ out[1] ^ out[2] ^ out[3]) == 0x9e3779b9u)\n"
                       "      dst[u] = make_uint4(out[0], out[1], out[2], out[3]);")]),
        # the quotient as x times the row's reciprocal, the exact division
        # only within 2^-15 of a rounding tie
        ("fast_div", [
            ("__device__ __forceinline__ uint32_t code_bits(float x, float scale) {\n" + CODE,
             "__device__ __forceinline__ uint32_t code_bits(float x, float scale, float r) {\n"
             "  float q = fminf(fmaxf(__fmul_rn(x, r), -127.f), 127.f);\n"
             "  const float m = __fadd_rn(q, 12582912.f);\n"
             "  if (!(fabsf(__fsub_rn(q, __fsub_rn(m, 12582912.f))) <= 0.5f - 0x1p-15f)) {\n"
             "    q = fminf(fmaxf(__fdiv_rn(x, scale), -127.f), 127.f);\n"
             "    return __float_as_uint(__fadd_rn(q, 12582912.f));\n"
             "  }\n"
             "  return __float_as_uint(m);\n"
             "  q = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);\n"),
            ("    uint32_t out[4];   // four codes a word, one word at a time\n",
             "    const float r = __frcp_rn(s);\n"
             "    uint32_t out[4];   // four codes a word, one word at a time\n")]
         + [(f"code_bits(element<T>(w[j], 4 * k{i}), s)",
             f"code_bits(element<T>(w[j], 4 * k{i}), s, r)")
            for i in ("", " + 1", " + 2", " + 3")]),
    ],
    "first": [
        ("full", []),
        ("no_div", [(FIRST_CODE, FIRST_CODE.replace("__fdiv_rn", "__fmul_rn"))]),
        ("no_round", [(FIRST_CODE, FIRST_CODE.replace(
            "rintf(__fdiv_rn(x, scale))", "__fdiv_rn(x, scale)"))]),
        ("no_store", [("      *reinterpret_cast<uint2*>(dst + c) = make_uint2(out[0], out[1]);",
                       "      if ((out[0] ^ out[1]) == 0x9e3779b9u)\n"
                       "        *reinterpret_cast<uint2*>(dst + c) = make_uint2(out[0], out[1]);")]),
        # the row read once: the second pass makes its codes from the
        # first pass's last registers (wrong codes of real values, time
        # only)
        ("no_reread", [
            ("  float amax = 0.f;\n", "  float amax = 0.f;\n  uint4 kept = make_uint4(0, 0, 0, 0);\n"),
            (FIRST_AMAX, FIRST_AMAX + "    kept = v;\n"),
            ("    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + c));\n"
             "    const T* e = reinterpret_cast<const T*>(&v);\n"
             "    uint32_t out[kE / 4] = {};",
             "    const uint4 v = kept;\n"
             "    const T* e = reinterpret_cast<const T*>(&v);\n"
             "    uint32_t out[kE / 4] = {};")]),
    ],
}
Q2_VARIANTS = {
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
for _vs in Q2_VARIANTS.values():
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


def build_all(sources, variants):
    """Compile every (layout, variant) library, all nvcc processes at
    once; yields ((layout, variant), path, ptxas lines)."""
    WORK.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for layout, path in sources.items():
        src = Path(path).read_text()
        for name, subs in variants[layout]:
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


def device_ms(fn, torch, iters=10, kernel="w8a8_gemm_kernel"):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
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


def q1_caller(layout, lib_path, R, K, x, plan, torch):
    """A function () -> None that launches the library's
    w8a8_quantize_rows on x (the first design takes no plan)."""
    lib = ctypes.CDLL(lib_path)
    ints = 0 if layout == "first" else 5
    lib.w8a8_quantize_rows.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * ints)
    lib.w8a8_quantize_rows.restype = ctypes.c_int
    q = torch.empty((R, K), dtype=torch.int8, device="cuda")
    s = torch.empty((R,), dtype=torch.float32, device="cuda")
    extra = () if layout == "first" else (
        plan.team, plan.units, plan.passes, plan.threads, plan.grid)

    def run():
        err = lib.w8a8_quantize_rows(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            s.data_ptr(), R, K, torch.cuda.current_stream().cuda_stream,
            *extra)
        if err:
            raise RuntimeError(f"w8a8_quantize_rows returned {err} for "
                               f"plan {extra}")
    return run


def spread(plan, factor, R, K):
    """The plan with each row over `factor` times the threads (2 or 1/2),
    or None where the kernel would not take it."""
    from vit_torch_tpu_torch.ops import quant
    team = int(plan.team * factor)
    units = K // 16
    if team < 1 or team > quant.Q_THREADS or plan.passes > 1:
        return None
    per = -(-units // team)
    if per > 4:
        return None
    threads = max(team, quant.Q_BLOCK)
    rows = threads // team
    return quant.QuantPlan(team, per, 1, threads, rows, -(-R // rows))


def time_q1_variants(libs, out, layouts):
    """Every Q1 variant of each layout at every shape, in turns; then the
    tree's kernel with each row over half and twice the plan's threads."""
    import torch
    from vit_torch_tpu_torch.ops import quant
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (R, K, nbytes) in enumerate(Q1_SHAPES):
        gen = torch.Generator().manual_seed(i)
        x = (torch.randn((R, K), generator=gen) * torch.exp(
            torch.randn((R, 1), generator=gen))).cuda()
        if nbytes == 2:
            x = x.bfloat16()
        plan = quant.quant_plan(R, K, nbytes, sms)
        runs = [((layout, name, plan if layout == "current" else None),
                 q1_caller(layout, libs[(layout, name)], R, K, x, plan,
                           torch))
                for layout in layouts for name, _ in Q1_VARIANTS[layout]]
        others = [(f"team*{f}", spread(plan, f, R, K)) for f in (0.5, 2)]
        others += [(f"threads={t}", plan._replace(
            threads=t, rows=t // plan.team,
            grid=-(-R // (t // plan.team))))
            for t in (128, 512) if t >= plan.team and t != plan.threads]
        for name, other in others:
            if other is not None:
                runs.append((("current", name, other), q1_caller(
                    "current", libs[("current", "full")], R, K, x, other,
                    torch)))
        times = {key: [] for key, _ in runs}
        for order in (runs, runs[::-1]):
            for key, fn in order:
                times[key].append((events_ms(fn, torch), device_ms(
                    fn, torch, kernel="quantize_rows_kernel")))
        bound = 1e3 * (R * K * (nbytes + 1) + 4 * R) / 3.35e12
        for (layout, name, used), ts in times.items():
            emit(out, {"q1_shape": [R, K], "bytes": nbytes,
                       "layout": layout, "variant": name,
                       "plan": used._asdict() if used else None,
                       "ms": [t[0] for t in ts],
                       "device_ms": [t[1] for t in ts],
                       "bound_ms": bound})


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
            for name, _ in Q2_VARIANTS[layout]:
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
    ap.add_argument("--kernel", choices=("q1", "q2"), default="q1")
    ap.add_argument("--first", help="the w8a8.cu of the kernel's first "
                    "design, timed in turns with the tree's")
    ap.add_argument("--out", default=str(WORK / "results.jsonl"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    libs_file = WORK / "libs.json"
    layouts = ["first"] * bool(args.first) + ["current"]
    variants, timer = {"q1": (Q1_VARIANTS, time_q1_variants),
                       "q2": (Q2_VARIANTS, time_variants)}[args.kernel]
    if args.child:   # the libraries are built
        libs = {tuple(k.split("/")): v for k, v in
                json.loads(libs_file.read_text()).items()}
        timer(libs, args.out, layouts)
        return 0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    sources = {"current": _build.CSRC / "w8a8.cu"}
    if args.first:
        sources["first"] = args.first
    t0 = time.perf_counter()
    libs = {}
    for key, lib, regs in build_all(sources, variants):
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
    cmd = [sys.executable, __file__, "--child", "--out", args.out,
           "--kernel", args.kernel]
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
