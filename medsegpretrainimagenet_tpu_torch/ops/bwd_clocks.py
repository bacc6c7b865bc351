"""Where the attention backward spends its cycles, on the card.

    python -m medsegpretrainimagenet_tpu_torch.ops.bwd_clocks \
        [--dtype float32|bfloat16] [--tree OTHER_CHECKOUT]

Copies ``csrc/`` (of this tree, or with ``--tree`` of another checkout)
under ``build/bwd_clocks/``, adds ``clock64()`` reads at the phase
boundaries of the body's walk over a block's pairs
(``csrc/attention_tile_bwd.cuh``: ``tile::grad_pairs_f32`` in float32,
``tile::grad_pairs_bf16`` in bf16, or the bf16 body before it,
``tile::grad_pairs``, where a checkout has that one), builds K1's backward
(``window_attention_bwd.cu``) from the copy, and runs it through this
tree's wrapper at the attention shapes of one ``swin_224_train`` step
(batch 24, dbias asked for).  For each shape it prints the kernel time
(L2-cold, :func:`kernel_ab.device_ms`) and the cycles a warp spends per
pair in each phase, summed over every warp of the launch and divided by
the pairs they walked (the phases of each body: :data:`BODIES`), and the
time without dbias asked for (no partials, and no second launch,
``tile::sum_partials``).  The blocks of an SM share it, so a phase's
cycles include the issue slots the other blocks' warps take meanwhile; a
wgmma issued in one phase and waited for in a later one counts in the
later.  The counters cost a few instructions a pair; the kernel times
beside them are the instrumented kernel's.  A checkout whose wrapper
takes other arguments than this tree's cannot be read so.  Needs the card
and nvcc; nothing runs at import.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Tuple

from . import _build

ROOT = Path(__file__).resolve().parents[2]
WORK = ROOT / "build" / "bwd_clocks"


class Body(NamedTuple):
    """A backward body's walk, as the counters find it in the header."""
    #: the start of the body's definition; the counters go in from there
    #: to the end of the function
    function: str
    #: the walk's loop header
    loop: str
    #: (anchor, the statement put before it), each anchor once in the body
    marks: Tuple[Tuple[str, str], ...]
    #: the walk's last lines, through its closing brace
    end: str
    #: the phases, in the order the counters hold them
    phases: Tuple[str, ...]


F32 = Body(
    "void grad_pairs_f32(",
    "  for (int p = 0; p < count; ++p) {\n",
    (("    land(p);\n    __syncthreads();  // the pair landed\n",
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
      "    long long ck6 = clock64();\n")),
    "    __syncthreads();  // the outputs left; the tiles are free for the "
    "next\n  }\n",
    ("land", "barrier 1", "phase 1", "barrier 2", "fetch", "phase 2 + store",
     "barrier 3"))

#: the bf16 body: every product on wgmma, the loads by tensor map.  Phase 1
#: is S, the softmax, dP, dS, P and dS into their tiles, and dQ; phase 2
#: is dV and dK
BF16 = Body(
    "void grad_pairs_bf16(",
    "  for (int p = 0; p < count; ++p) {\n",
    (("    if (tma)\n      mbar_wait(t.bar, p & 1);  // the pair landed\n",
      "    long long ck0 = clock64();\n"),
     ("    __syncwarp();  // the strip's staged outputs stored\n",
      "    long long ck1 = clock64();\n"),
     ("    hold_regs(da);\n    hold_acc(dq);\n    __syncthreads();  // P and "
      "dS whole\n", "    long long ck2 = clock64();\n"),
     ("    float dv[W / 8][4], dk[W / 8][4];\n",
      "    long long ck3 = clock64();\n"),
     ("    // the tiles of q, k, v and g are free for the next pair, those "
      "of P\n", "    long long ck4 = clock64();\n"),
     ("    if (p + 1 < count) load(p + 1);\n",
      "    long long ck5 = clock64();\n"),
     ("    if (r0 < n) {\n      stage_bf16<W>(t.p_hi, dq, scale, r0, lane);\n",
      "    long long ck6 = clock64();\n")),
    "      store(p);\n    }\n  }\n",
    ("land", "phase 1", "barrier 1", "phase 2", "barrier 2", "issue",
     "stores"))

#: the bf16 body before it (mma.sync, cp.async double-buffered), to read a
#: checkout that still has it
BF16_MMA_SYNC = Body(
    "void grad_pairs(",
    "  for (int t = 0; t < count; ++t) {\n",
    (("    if (t + 1 < count) load(t + 1, buf + ((t + 1) & 1) * pe);\n",
      "    long long ck0 = clock64();\n"),
     ("    cp_async_commit();\n    cp_async_wait_one();\n",
      "    long long ck1 = clock64();\n"),
     ("    float dq[DP / 8][4];\n", "    long long ck2 = clock64();\n"),
     ("    __syncthreads();  // P and dS whole;",
      "    long long ck3 = clock64();\n"),
     ("    if (active) {\n      float c[DP / 8][4];\n",
      "    long long ck4 = clock64();\n"),
     ("    __syncthreads();  // q read for the last time\n",
      "    long long ck5 = clock64();\n"),
     ("    if (active) {\n      stage<DP, T>(q, dq, scale, r0, n, lane);\n",
      "    long long ck6 = clock64();\n"),
     ("    __syncthreads();  // the buffer is free for pair t + 2\n",
      "    long long ck7 = clock64();\n")),
    "    __syncthreads();  // the buffer is free for pair t + 2\n  }\n",
    ("issue", "land", "phase 1", "barrier 1", "phase 2", "barrier 2",
     "stores", "barrier 3"))

#: per dtype the bodies the counters know, the current one first
BODIES = {"float32": (F32,), "bfloat16": (BF16, BF16_MMA_SYNC)}

#: the float32 body's marks and phases
_MARKS, PHASES = F32.marks, F32.phases


def body_of(header: str, dtype: str = "float32") -> Body:
    """The body of *dtype* that *header* holds; ValueError if none."""
    for body in BODIES[dtype]:
        if body.function in header:
            return body
    raise ValueError(f"no {dtype} backward body found (looked for "
                     f"{[b.function for b in BODIES[dtype]]})")


def instrument(header: str, dtype: str = "float32") -> str:
    """*header* (``attention_tile_bwd.cuh``) with the counters in its
    *dtype* body (:func:`body_of`): the clock64() reads of its marks, their
    differences summed per thread and, at the end of the walk, lane 0 of
    each warp adding them and its pair count into ``bwd_clocks[K + 1]``
    (K phases).  Raises ValueError if an anchor is not there once (the body
    changed: update its Body)."""
    body = body_of(header, dtype)
    start = header.find(body.function)
    stop = header.find("\n}\n", start)
    head, text, tail = header[:start], header[start:stop], header[stop:]
    name = body.function[len("void "):-1]
    for anchor, mark in body.marks:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor not found once in {name}: {anchor!r}")
        text = text.replace(anchor, mark + anchor)
    k = len(body.phases)
    if text.count(body.loop) != 1:
        raise ValueError(f"{name}'s walk over the pairs not found")
    text = text.replace(body.loop, f"  unsigned long long cks[{k}] = {{}};\n"
                        + body.loop)
    if text.count(body.end) != 1:
        raise ValueError(f"the end of {name}'s walk not found")
    reads = ", ".join(f"ck{i}" for i in range(k + 1))
    text = text.replace(body.end, body.end[:-4] + f"""
    const long long ck{k} = clock64();
    const long long cs[{k + 1}] = {{{reads}}};
    for (int i = 0; i < {k}; ++i) cks[i] += cs[i + 1] - cs[i];
  }}
  if ((threadIdx.x & 31) == 0) {{
    for (int i = 0; i < {k}; ++i) atomicAdd(&bwd_clocks[i], cks[i]);
    atomicAdd(&bwd_clocks[{k}], static_cast<unsigned long long>(count));
  }}
""")
    return head.replace("namespace tile {",
                        f"__device__ unsigned long long bwd_clocks[{k + 1}];"
                        "\nnamespace tile {", 1) + text + tail


_READER = """
// the counters of bwd_clocks.py: zeroed (reset) or copied into out[{n}]
extern "C" int bwd_clocks_read(unsigned long long* out, int reset) {{
  if (reset) {{
    const unsigned long long zero[{n}] = {{}};
    return static_cast<int>(cudaMemcpyToSymbol(bwd_clocks, zero,
                                               sizeof(zero)));
  }}
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, bwd_clocks, {n} * sizeof(unsigned long long)));
}}
"""


def build(dtype: str = "float32", csrc: Path = _build.CSRC):
    """K1's backward library from an instrumented copy of *csrc*, and the
    body it instruments."""
    src = WORK / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    header = src / "attention_tile_bwd.cuh"
    body = body_of(header.read_text(), dtype)
    header.write_text(instrument(header.read_text(), dtype))
    kernel = src / "window_attention_bwd.cu"
    kernel.write_text(kernel.read_text()
                      + _READER.format(n=len(body.phases) + 1))
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
    return lib, body


def main(argv=None) -> int:
    import torch

    from ..models.swin import _shift_attn_mask
    from . import kernel_ab
    from . import window_attention as wa

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    parser.add_argument("--tree", type=Path, default=None,
                        help="instrument another checkout's csrc/")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_clocks: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    csrc = _build.CSRC if args.tree is None \
        else args.tree.resolve() / "medsegpretrainimagenet_tpu_torch" / "csrc"
    lib, body = build(args.dtype, csrc)
    # the wrapper loads the library by name: it takes the instrumented one
    _build._LOADED["window_attention_bwd"] = lib
    k = len(body.phases)
    counters = (ctypes.c_ulonglong * (k + 1))()
    gen = torch.Generator().manual_seed(4)
    scale = kernel_ab.HEAD_DIM ** -0.5
    dtype = getattr(torch, args.dtype)
    label = "f32" if args.dtype == "float32" else "bf16"
    tree = "this tree" if args.tree is None else str(args.tree)
    print(f"[clocks] {tree}: {body.function[len('void '):-1]}, phases "
          f"{', '.join(body.phases)}", flush=True)
    for shape, level, heads, n_w, masked, calls in kernel_ab._shapes(
            args.dtype, backward=True):
        res = 56 // 2 ** level
        q, k_, v, g = (torch.randn(kernel_ab.BATCH * n_w, heads,
                                   kernel_ab.TOKENS, kernel_ab.HEAD_DIM,
                                   generator=gen).to("cuda", dtype)
                       for _ in range(4))
        bias = (0.02 * torch.randn(heads, kernel_ab.TOKENS,
                                   kernel_ab.TOKENS, generator=gen)).cuda()
        mask = torch.from_numpy(_shift_attn_mask(
            (res, res), kernel_ab.WINDOW, kernel_ab.WINDOW // 2)).cuda() \
            if masked else None

        def backward(q, k, v, g):
            return wa.window_attention_backward_cuda(
                q, k, v, bias, mask, scale, g, mask_grad=False)

        backward(q, k_, v, g)
        torch.cuda.synchronize()
        lib.bwd_clocks_read(counters, 1)
        backward(q, k_, v, g)
        torch.cuda.synchronize()
        if lib.bwd_clocks_read(counters, 0) != 0:
            raise SystemExit("bwd_clocks: reading the counters failed")
        pairs = counters[k]
        cycles = [counters[i] / pairs for i in range(k)]
        copies = kernel_ab.input_copies(q, k_, v, g)
        ms = kernel_ab.device_ms(backward, copies)
        # without dbias: no partials, no second launch (sum_partials)
        alone = kernel_ab.device_ms(
            lambda q, k, v, g: wa.window_attention_backward_cuda(
                q, k, v, bias, mask, scale, g, bias_grad=False,
                mask_grad=False), copies)
        del copies
        print(f"[clocks] k1 {shape} {label} backward x{calls}: {ms:.4f} ms "
              f"L2-cold ({alone:.4f} without dbias); cycles a warp spends "
              f"per pair: "
              + ", ".join(f"{name} {c:.0f}" for name, c in
                          zip(body.phases, cycles))
              + f"; total {sum(cycles):.0f}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
