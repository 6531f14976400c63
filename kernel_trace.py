"""Where a ``fused_conv_pool`` launch spends its time, from inside the kernel
(run from the repo root on a GPU):

    python3 kernel_trace.py [--variant base|nobuild|nomma] [--levels enc0,dec0]

Builds a copy of ``hm_vae_torch/csrc/fused_conv_pool.cu`` with
``%globaltimer`` stamps taken by thread 0 of every block (into
``build/kernel_trace/``), runs each chosen level of the len-64 model once at
batch 8 and 237 in bf16 and f32, and prints one JSON line per level: the
device time of a launch (20 launches in a CUDA graph), the kernel's span, and
each block's mean phases: prologue (start to first stage), per chunk the wait
for its bulk copies, the im2col build and the wgmma, and the epilogue.

``--variant nobuild`` skips the im2col build and ``nomma`` the wgmma: their
outputs are wrong, their times say what the skipped phase costs.
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


def stamp(slot, value="gtime()"):
    return STAMP.format(slot=slot, value=value)


def patched_source(variant: str) -> str:
    """The kernel with stamps: 0 start, 1 before the chunk loop, 2+3i after
    chunk i's copies arrived, 3+3i after its im2col, 4+3i after its wgmma
    (i < 4), 20 after the loop, 21 and 22 after the epilogue's cluster
    syncs (or 21 = 22 = the end without a split), 31 the block's chunks."""
    src = open(os.path.join(ROOT, "hm_vae_torch", "csrc", "fused_conv_pool.cu")).read()

    def sub(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"kernel source changed; anchor not found once: {old!r}")
        src = src.replace(old, new)

    sub("namespace {\n", "namespace {\n__device__ unsigned long long g_trace[%d];\n"
        "__device__ __forceinline__ unsigned long long gtime() { unsigned long long t; "
        'asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t)); return t; }\n'
        % (BLOCKS * SLOTS))
    sub("  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n  " + stamp(0) + "\n")
    sub("  for (int i = 0; i < n_mine; ++i) {\n",
        f"  {stamp(1)}\n  {stamp(31, 'n_mine')}\n  for (int i = 0; i < n_mine; ++i) {{\n")
    wait = "    mbar_wait(smem_addr(bars + stage), (i / Tr::kStages) & 1);\n"
    sub(wait, wait + "    if (i < 4) { " + stamp("2 + 3 * i") + " }\n")
    built = "    __syncthreads();  // the im2col tile is complete\n"
    sub(built, built + "    if (i < 4) { " + stamp("3 + 3 * i") + " }\n")
    summed = "    for (int r = 0; r < 16; ++r) sum[r] += acc[r];\n  }\n"
    sub(summed, summed[:-4] + "\n    if (i < 4) { " + stamp("4 + 3 * i") + " }\n  }\n  "
        + stamp(20) + "\n")
    sub("    return;\n  }\n", "    " + stamp(21) + "\n    " + stamp(22) + "\n    return;\n  }\n")
    first = "  cluster.sync();  // every block's partial tile is in its shared memory\n"
    sub(first, first + "  " + stamp(21) + "\n")
    last = "  cluster.sync();  // no block leaves while another reads its partial tile\n"
    sub(last, last + "  " + stamp(22) + "\n")
    if variant == "nobuild":
        sub("    for (int k = kp; k < K; k += 2) {", "    for (int k = kp; k < 0; k += 2) {")
    elif variant == "nomma":
        sub("    for (int k = 0; k < K; ++k) {\n      const uint32_t off",
            "    for (int k = 0; k < 0; ++k) {\n      const uint32_t off")
    return src + (
        '\nextern "C" int hmvae_trace_copy(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n"
        'extern "C" int hmvae_trace_clear() {\n'
        "  static unsigned long long zeros[%d];\n"
        "  return (int)cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros));\n}\n"
        % (BLOCKS * SLOTS))


def build(variant: str) -> ctypes.CDLL:
    from hm_vae_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"fused_conv_pool_{variant}.cu")
    with open(src, "w") as f:
        f.write(patched_source(variant))
    lib = os.path.join(OUT, f"libtrace_{variant}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True)
    return ctypes.CDLL(lib)


def phases(trace: np.ndarray) -> dict:
    t = trace[trace[:, 0] > 0].astype(np.int64)
    us = lambda a, b, rows=t: float(np.mean(rows[:, b] - rows[:, a]) / 1e3)  # noqa: E731
    out = {"blocks": len(t), "chunks_max": int(t[:, 31].max()),
           "span_us": float((t[:, 22].max() - t[:, 0].min()) / 1e3),
           "prologue_us": us(0, 1), "loop_us": us(1, 20), "epilogue_us": us(20, 22)}
    for i in range(2):
        rows = t[t[:, 31] > i]
        if len(rows):
            out[f"chunk{i}"] = {"wait_us": us(1 + 3 * i, 2 + 3 * i, rows),
                                "build_us": us(2 + 3 * i, 3 + 3 * i, rows),
                                "mma_us": us(3 + 3 * i, 4 + 3 * i, rows)}
    return out


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="base", choices=("base", "nobuild", "nomma"))
    ap.add_argument("--levels", default="enc0,enc3,dec0,dec3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trace.py needs a GPU")

    import chip_smoke
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    lib = build(args.variant)
    fn = lib.hmvae_fused_conv_pool
    fn.argtypes = fcp.ARGTYPES
    fn.restype = ctypes.c_int
    lib.hmvae_error_string.argtypes = [ctypes.c_int]
    lib.hmvae_error_string.restype = ctypes.c_char_p
    fcp._library = lambda: (lib, fn)

    cfg = load_config(chip_smoke.CONFIG)
    st = get_structure(cfg.model)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to("cuda")
    buf = np.zeros(BLOCKS * SLOTS, dtype=np.uint64)
    for dtype in (torch.bfloat16, torch.float32):
        for batch in (chip_smoke.BATCH, chip_smoke.VIBE_BATCH):
            for name, conv, T_in in chip_smoke.level_cases(model, st):
                if name not in args.levels.split(","):
                    continue
                conv = copy.deepcopy(conv)
                conv.dtype = dtype
                packed = conv.packed_operands()
                x = torch.randn((batch, packed.in_channels, T_in), generator=gen).to(
                    "cuda", dtype)
                launch = lambda: fcp.fused_conv_pool_packed(x, packed)  # noqa: E731
                graph_ms = chip_smoke.device_ms(launch)
                lib.hmvae_trace_clear()
                launch()
                torch.cuda.synchronize()
                lib.hmvae_trace_copy(buf.ctypes.data)
                print(json.dumps({"variant": args.variant, "level": name, "batch": batch,
                                  "dtype": str(dtype).replace("torch.", ""),
                                  "graph_us": graph_ms * 1e3,
                                  **phases(buf.reshape(BLOCKS, SLOTS))}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
