"""Where the float32 attention backward spends its cycles, on the card.

    python -m medsegpretrainimagenet_tpu_torch.ops.bwd_clocks

Copies ``csrc/`` under ``build/bwd_clocks/``, adds ``clock64()`` reads at
the phase boundaries of ``tile::grad_pairs_f32``'s walk over a block's
pairs (``csrc/attention_tile_bwd.cuh``), builds K1's backward
(``window_attention_bwd.cu``) from the copy, and runs it through the
port's own wrapper at the attention shapes of one ``swin_224_train`` step
(batch 24, float32, dbias asked for).  For each shape it prints the kernel
time (L2-cold, :func:`kernel_ab.device_ms`) and the cycles a warp spends
per pair in each phase, summed over every warp of the launch and divided
by the pairs they walked: loading the pair's split tiles (``land``), the
barrier after it, phase 1 (S, P, dP, dS, dQ), the barrier after it,
issuing the next pair's loads (``fetch``), phase 2 with the stores, and
the last barrier.  Two blocks share an SM, so a phase's cycles include the
issue slots the other block's warps take meanwhile.  The counters cost a
few instructions a pair; the kernel times beside them are the
instrumented kernel's.  Needs the card and nvcc; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

from . import _build

ROOT = Path(__file__).resolve().parents[2]
WORK = ROOT / "build" / "bwd_clocks"

#: the phases, in the order the counters hold them
PHASES = ("land", "barrier 1", "phase 1", "barrier 2", "fetch",
          "phase 2 + store", "barrier 3")

#: (anchor in grad_pairs_f32, the statement put before it); each anchor
#: must occur once from grad_pairs_f32 on
_MARKS = (
    ("    land(p);\n    __syncthreads();  // the pair landed\n",
     "    long long ck0 = clock64();\n"),
    ("    __syncthreads();  // the pair landed\n",
     "    long long ck1 = clock64();\n"),
    ("    grad_queries_f32<DP>(t, r, ldb, n, scale, r0, lane, acc);\n",
     "    long long ck2 = clock64();\n"),
    ("    __syncthreads();  // P and dS whole;",
     "    long long ck3 = clock64();\n"),
    ("    if (kEarly && vec && p + 1 < count) fetch(p + 1);\n",
     "    long long ck4 = clock64();\n"),
    ("    if (active) {\n      float c[2][DP / 8][4];\n",
     "    long long ck5 = clock64();\n"),
    ("    __syncthreads();  // the outputs left;",
     "    long long ck6 = clock64();\n"),
)


def instrument(header: str) -> str:
    """*header* (``attention_tile_bwd.cuh``) with the counters: the
    clock64() reads of _MARKS, their differences summed per thread and, at
    the end of the walk, lane 0 of each warp adding them and its pair count
    into ``bwd_clocks[8]``.  Raises ValueError if an anchor is not there
    once (the body changed: update _MARKS)."""
    start = header.find("void grad_pairs_f32(")
    if start < 0:
        raise ValueError("grad_pairs_f32 not found")
    head, header = header[:start], header[start:]
    for anchor, mark in _MARKS:
        if header.count(anchor) != 1:
            raise ValueError(f"anchor not found once in grad_pairs_f32: "
                             f"{anchor!r}")
        header = header.replace(anchor, mark + anchor)
    loop = "  for (int p = 0; p < count; ++p) {\n    long long ck0"
    if header.count(loop) != 1:
        raise ValueError("grad_pairs_f32's walk over the pairs not found")
    header = header.replace(loop, "  unsigned long long cks[7] = {};\n"
                            + loop)
    end = ("    __syncthreads();  // the outputs left; the tiles are free "
           "for the next\n  }\n")
    if header.count(end) != 1:
        raise ValueError("the end of grad_pairs_f32's walk not found")
    header = header.replace(end, end[:-4] + """
    const long long ck7 = clock64();
    const long long cs[8] = {ck0, ck1, ck2, ck3, ck4, ck5, ck6, ck7};
    for (int i = 0; i < 7; ++i) cks[i] += cs[i + 1] - cs[i];
  }
  if (lane == 0) {
    for (int i = 0; i < 7; ++i) atomicAdd(&bwd_clocks[i], cks[i]);
    atomicAdd(&bwd_clocks[7], static_cast<unsigned long long>(count));
  }
""")
    return head.replace("namespace tile {",
                        "__device__ unsigned long long bwd_clocks[8];\n"
                        "namespace tile {", 1) + header


_READER = """
// the counters of bwd_clocks.py: zeroed (reset) or copied into out[8]
extern "C" int bwd_clocks_read(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {};
    return static_cast<int>(cudaMemcpyToSymbol(bwd_clocks, zero,
                                               sizeof(zero)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, bwd_clocks, 8 * sizeof(unsigned long long)));
}
"""


def build() -> ctypes.CDLL:
    """K1's backward library from an instrumented copy of csrc/."""
    src = WORK / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    header = src / "attention_tile_bwd.cuh"
    header.write_text(instrument(header.read_text()))
    kernel = src / "window_attention_bwd.cu"
    kernel.write_text(kernel.read_text() + _READER)
    target = WORK / "window_attention_bwd_clocks.so"
    run = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(kernel)],
        capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented copy:\n"
                           f"{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(target))
    lib.bwd_clocks_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bwd_clocks_read.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    from ..models.swin import _shift_attn_mask
    from . import kernel_ab
    from . import window_attention as wa

    if not torch.cuda.is_available():
        raise SystemExit("bwd_clocks: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    lib = build()
    # the wrapper loads the library by name: it takes the instrumented one
    _build._LOADED["window_attention_bwd"] = lib
    counters = (ctypes.c_ulonglong * 8)()
    gen = torch.Generator().manual_seed(4)
    scale = kernel_ab.HEAD_DIM ** -0.5
    for shape, level, heads, n_w, masked, calls in kernel_ab._shapes(
            "float32", backward=True):
        res = 56 // 2 ** level
        q, k, v, g = (torch.randn(kernel_ab.BATCH * n_w, heads,
                                  kernel_ab.TOKENS, kernel_ab.HEAD_DIM,
                                  generator=gen).cuda() for _ in range(4))
        bias = (0.02 * torch.randn(heads, kernel_ab.TOKENS,
                                   kernel_ab.TOKENS, generator=gen)).cuda()
        mask = torch.from_numpy(_shift_attn_mask(
            (res, res), kernel_ab.WINDOW, kernel_ab.WINDOW // 2)).cuda() \
            if masked else None

        def backward(q, k, v, g):
            return wa.window_attention_backward_cuda(
                q, k, v, bias, mask, scale, g, mask_grad=False)

        backward(q, k, v, g)
        torch.cuda.synchronize()
        lib.bwd_clocks_read(counters, 1)
        backward(q, k, v, g)
        torch.cuda.synchronize()
        if lib.bwd_clocks_read(counters, 0) != 0:
            raise SystemExit("bwd_clocks: reading the counters failed")
        pairs = counters[7]
        cycles = [counters[i] / pairs for i in range(7)]
        ms = kernel_ab.device_ms(backward, kernel_ab.input_copies(q, k, v, g))
        print(f"[clocks] k1 {shape} f32 backward x{calls}: {ms:.4f} ms "
              f"L2-cold; cycles a warp spends per pair: "
              + ", ".join(f"{name} {c:.0f}" for name, c in
                          zip(PHASES, cycles))
              + f"; total {sum(cycles):.0f}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
