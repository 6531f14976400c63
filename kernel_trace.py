"""Where a launch of one of the port's kernels spends its time, from inside
the kernel (run from the repo root on a GPU):

    python3 kernel_trace.py [--kernel fwd|dgrad|wgrad] [--variant base|nobuild|nomma]
                            [--levels enc0,dec0]

Builds a copy of the kernel's source (``hm_vae_torch/csrc/fused_conv_pool.cu``
for ``fwd``, ``fused_conv_pool_bwd.cu`` for ``dgrad`` and ``wgrad``) with
``%globaltimer`` stamps taken by thread 0 of every block (into
``build/kernel_trace/``), runs each chosen level of the len-64 model once and
prints one JSON line per level: the device time of a launch (20 launches in a
CUDA graph), the kernel's span, and each block's mean phases: prologue (start
to the first stage), per stage (a forward chunk, a backward column or row
tile) the wait for its copies, the staging (im2col build), the product, and
the epilogue (its reduction, then the stores).  The forward runs at batch 8
and 237 in bf16 and f32; the backward at batch 8 in f32, on the operands
``chip_smoke.py`` gives it.

``--variant nobuild`` skips the forward's im2col build and ``nomma`` its
wgmma: their outputs are wrong, their times say what the skipped phase costs.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "kernel_trace")
SLOTS, BLOCKS = 32, 8192
STAMP = ("if (threadIdx.x == 0) g_trace[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x "
         "+ blockIdx.x) % {B} * {S} + ({{slot}})] = {{value}};").format(B=BLOCKS, S=SLOTS)
SOURCES = {"fwd": "fused_conv_pool", "dgrad": "fused_conv_pool_bwd",
           "wgrad": "fused_conv_pool_bwd"}


def stamp(slot, value="gtime()"):
    return STAMP.format(slot=slot, value=value)


def _fwd_patches(variant):
    """0 start, 1 before the chunk loop, 2+3i after chunk i's copies
    arrived, 3+3i after its im2col, 4+3i after its wgmma (i < 4), 20 after
    the loop, 21 and 22 after the epilogue's cluster syncs (or 21 = 22 = the
    end without a split), 31 the block's chunks."""
    wait = "    mbar_wait(smem_addr(bars + stage), (i / Tr::kStages) & 1);\n"
    built = "    __syncthreads();  // the im2col tile is complete\n"
    summed = "    for (int r = 0; r < 16; ++r) sum[r] += acc[r];\n  }\n"
    first = "  cluster.sync();  // every block's partial tile is in its shared memory\n"
    last = "  cluster.sync();  // no block leaves while another reads its partial tile\n"
    patches = [
        ("  const int tid = threadIdx.x;\n",
         "  const int tid = threadIdx.x;\n  " + stamp(0) + "\n"),
        ("  for (int i = 0; i < n_mine; ++i) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'n_mine')}\n  for (int i = 0; i < n_mine; ++i) {{\n"),
        (wait, wait + "    if (i < 4) { " + stamp("2 + 3 * i") + " }\n"),
        (built, built + "    if (i < 4) { " + stamp("3 + 3 * i") + " }\n"),
        (summed, summed[:-4] + "\n    if (i < 4) { " + stamp("4 + 3 * i") + " }\n  }\n  "
         + stamp(20) + "\n"),
        ("    return;\n  }\n", "    " + stamp(21) + "\n    " + stamp(22) + "\n    return;\n  }\n"),
        (first, first + "  " + stamp(21) + "\n"),
        (last, last + "  " + stamp(22) + "\n"),
    ]
    if variant == "nobuild":
        patches.append(("    for (int k = kp; k < nk; k += 2) {",
                        "    for (int k = kp; k < 0; k += 2) {"))
    elif variant == "nomma":
        patches.append(("    for (int k = 0; k < nk; ++k) {\n      const uint32_t off",
                        "    for (int k = 0; k < 0; ++k) {\n      const uint32_t off"))
    return patches


def _dgrad_patches():
    """The same slots over the halves of a block's live row tiles (stage i):
    2+3i after the stage's gy and y arrived, 3+3i after g is split and
    padded and the weight rows arrived, 4+3i after the products; 21 after the partial gxpad is written
    (cluster sync), 22 after the cluster's sum, the reflect fold and the
    stores."""
    return [
        ("  const int c0 = blockIdx.x * kDC;\n",
         "  const int c0 = blockIdx.x * kDC;\n  " + stamp(0) + "\n"),
        ("  for (int i = 0; i < n_mine; ++i) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'n_mine')}\n  for (int i = 0; i < n_mine; ++i) {{\n"),
        ("    mbar_wait(smem_addr(bars + kStages), i & 1);\n",
         "    mbar_wait(smem_addr(bars + kStages), i & 1);\n    if (i < 4) { "
         + stamp("2 + 3 * i") + " }\n"),
        ("    __syncthreads();  // g and the weight rows are staged\n",
         "    __syncthreads();  // g and the weight rows are staged\n    if (i < 4) { "
         + stamp("3 + 3 * i") + " }\n"),
        ("    __syncthreads();  // every warp is done with this stage's weight rows and g2\n",
         "    __syncthreads();  // every warp is done with this stage's weight rows and g2\n"
         "    if (i < 4) { " + stamp("4 + 3 * i") + " }\n"),
        ("  // gxpad of the block's rows -> out_s",
         "  " + stamp(20) + "\n  // gxpad of the block's rows -> out_s"),
        ("    __syncthreads();\n  {\n    const float* part[kMaxSplit];\n",
         "    __syncthreads();\n  " + stamp(21) + "\n  {\n    const float* part[kMaxSplit];\n"),
        ("  if (split > 1) cluster.sync();  // no block leaves while another reads its partial gxpad\n",
         "  if (split > 1) cluster.sync();  // no block leaves while another reads its partial "
         "gxpad\n  " + stamp(22) + "\n"),
    ]


def _wgrad_patches():
    """Over a block's stages of batches: 1 after x is staged (padded and
    split), 2+3i after stage i's bulk copies arrived, 3+3i after g is
    written in fragment order, 4+3i after the products; 21 after the
    partial tile is written (cluster sync), 22 after the cluster's sum and
    the stores."""
    summed = "          for (int r = 0; r < 4; ++r) sum[a][qq][r] += acc[a][qq][r];\n    }\n  }\n"
    return [
        ("  const int rt = wrow[e], chunk = wchunk[e];\n",
         "  const int rt = wrow[e], chunk = wchunk[e];\n  " + stamp(0) + "\n"),
        ("  for (int i = 0; i < n_st; ++i) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'n_st')}\n  for (int i = 0; i < n_st; ++i) {{\n"),
        ("    mbar_wait(smem_addr(bars + 1 + slot), (i / L.slots) & 1);\n",
         "    mbar_wait(smem_addr(bars + 1 + slot), (i / L.slots) & 1);\n    if (i < 4) { "
         + stamp("2 + 3 * i") + " }\n"),
        ("    __syncthreads();  // the fragments are staged; the stage's copies are read\n",
         "    __syncthreads();  // the fragments are staged; the stage's copies are read\n"
         "    if (i < 4) { " + stamp("3 + 3 * i") + " }\n"),
        (summed, summed[:-4] + "    if (i < 4) { " + stamp("4 + 3 * i") + " }\n  }\n  "
         + stamp(20) + "\n"),
        ("    __syncthreads();\n  const float* part[kMaxSplit];\n",
         "    __syncthreads();\n  " + stamp(21) + "\n  const float* part[kMaxSplit];\n"),
        ("  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile\n",
         "  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile\n  "
         + stamp(22) + "\n"),
    ]


def patched_source(variant: str = "base", kernel: str = "fwd") -> str:
    """The kernel's source with stamps (slots: see the patch lists)."""
    src = open(os.path.join(ROOT, "hm_vae_torch", "csrc", SOURCES[kernel] + ".cu")).read()
    if kernel != "fwd" and variant != "base":
        raise ValueError(f"--variant {variant} is for the forward kernel only")
    patches = {"fwd": lambda: _fwd_patches(variant), "dgrad": _dgrad_patches,
               "wgrad": _wgrad_patches}[kernel]()
    patches.insert(0, ("namespace {\n", "namespace {\n__device__ unsigned long long g_trace[%d];\n"
                       "__device__ __forceinline__ unsigned long long gtime() { unsigned long "
                       'long t; asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t)); '
                       "return t; }\n" % (BLOCKS * SLOTS)))
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel source changed; anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + (
        '\nextern "C" int hmvae_trace_copy(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n"
        'extern "C" int hmvae_trace_clear() {\n'
        "  static unsigned long long zeros[%d];\n"
        "  return (int)cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros));\n}\n"
        % (BLOCKS * SLOTS))


def build(variant: str, kernel: str) -> ctypes.CDLL:
    from hm_vae_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{kernel}_{variant}.cu")
    with open(src, "w") as f:
        f.write(patched_source(variant, kernel))
    lib = os.path.join(OUT, f"libtrace_{kernel}_{variant}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", lib,
                    src], check=True)
    lib = ctypes.CDLL(lib)
    lib.hmvae_error_string.argtypes = [ctypes.c_int]
    lib.hmvae_error_string.restype = ctypes.c_char_p
    return lib


def phases(trace: np.ndarray) -> dict:
    t = trace[trace[:, 0] > 0].astype(np.int64)
    us = lambda a, b, rows=t: float(np.mean(rows[:, b] - rows[:, a]) / 1e3)  # noqa: E731
    out = {"blocks": len(t), "stages_max": int(t[:, 31].max()),
           "span_us": float((t[:, 22].max() - t[:, 0].min()) / 1e3),
           "prologue_us": us(0, 1), "loop_us": us(1, 20), "epilogue_us": us(20, 22),
           "reduce_us": us(20, 21)}
    for i in range(2):
        rows = t[t[:, 31] > i]
        if len(rows):
            out[f"stage{i}"] = {"wait_us": us(1 + 3 * i, 2 + 3 * i, rows),
                                "build_us": us(2 + 3 * i, 3 + 3 * i, rows),
                                "mma_us": us(3 + 3 * i, 4 + 3 * i, rows)}
    return out


def _trace(lib, buf, launch) -> dict:
    """Device ms of a launch (CUDA graph), then one stamped launch's phases."""
    import chip_smoke

    graph_ms = chip_smoke.device_ms(launch)
    lib.hmvae_trace_clear()
    launch()
    torch.cuda.synchronize()
    lib.hmvae_trace_copy(buf.ctypes.data)
    return {"graph_us": graph_ms * 1e3, **phases(buf.reshape(BLOCKS, SLOTS))}


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="fwd", choices=tuple(SOURCES))
    ap.add_argument("--variant", default="base", choices=("base", "nobuild", "nomma"))
    ap.add_argument("--levels", default=None,
                    help="comma-separated levels (default: enc0,enc3,dec0,dec3 for fwd, all "
                         "eight for the backward)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trace.py needs a GPU")

    import chip_smoke
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    lib = build(args.variant, args.kernel)
    if args.kernel == "fwd":
        fcp._library = lambda: (lib, fcp._bind(lib, "hmvae_fused_conv_pool", fcp.ARGTYPES))
    else:
        _build.load("fused_conv_pool")  # the forward, for y
        fcp._bwd_library = lambda: (lib, fcp._bind(lib, "hmvae_conv_dgrad", fcp.DGRAD_ARGTYPES),
                                    fcp._bind(lib, "hmvae_conv_wgrad", fcp.WGRAD_ARGTYPES))
    levels = args.levels or ("enc0,enc3,dec0,dec3" if args.kernel == "fwd" else
                             "enc0,enc1,enc2,enc3,dec0,dec1,dec2,dec3")

    cfg = load_config(chip_smoke.CONFIG)
    st = get_structure(cfg.model)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to("cuda")
    buf = np.zeros(BLOCKS * SLOTS, dtype=np.uint64)
    cases = [c for c in chip_smoke.level_cases(model, st) if c[0] in levels.split(",")]
    if args.kernel == "fwd":
        for dtype in (torch.bfloat16, torch.float32):
            for batch in (chip_smoke.BATCH, chip_smoke.VIBE_BATCH):
                for name, conv, T_in in cases:
                    conv = copy.deepcopy(conv)
                    conv.dtype = dtype
                    packed = conv.packed_operands()
                    x = torch.randn((batch, packed.in_channels, T_in), generator=gen).to(
                        "cuda", dtype)
                    row = _trace(lib, buf, lambda: fcp.fused_conv_pool_packed(x, packed))
                    print(json.dumps({"kernel": "fwd", "variant": args.variant, "level": name,
                                      "batch": batch, "dtype": str(dtype).replace("torch.", ""),
                                      **row}), flush=True)
    else:
        for name, conv, T_in in cases:
            s, wf, bf, x, y, gy = chip_smoke.bwd_inputs(conv, T_in, gen)
            if args.kernel == "dgrad":
                launch = lambda: fcp.fused_conv_pool_dgrad(gy, y, wf, s, T_in)  # noqa: E731
            else:
                launch = lambda: fcp.fused_conv_pool_wgrad(gy, y, x, s)  # noqa: E731
            print(json.dumps({"kernel": args.kernel, "level": name, "batch": chip_smoke.BATCH,
                              "dtype": "float32", **_trace(lib, buf, launch)}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
