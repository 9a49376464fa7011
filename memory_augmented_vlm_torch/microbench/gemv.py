"""The decode GEMV: the CUDA kernel `csrc/gemv.cu`, its plain PyTorch
version, and the micro-benchmark of a chain of them.

Counterpart of the JAX package's `tools_gemv_bench.py`, whose Pallas kernel
(`_gemv_kernel`, called by `pallas_gemv`) computes y (1, N) = x (1, K) .
W (K, N) with both read as fp32, fp32 accumulation and y in x's dtype
(bf16). W is (K, N) row-major, the port's layout for a float kernel.

    python -m memory_augmented_vlm_torch.microbench.gemv

chains the tool's 12 layers of 896 -> 4864 -> 896 (bf16) and times one
chain through the kernel and through `torch.matmul`, each captured in a
CUDA graph and replayed (CUDA events, median of 5), so that the device's
time is measured and not the host's time to enqueue 24 small launches. The
chain reads 209.2 MB of weights, four times the H100's 50 MB L2, so each
replay streams them from device memory; a single product repeated would
read its 8.7 MB from L2 and show more than the memory's rate. It prints
GB/s and the share of 3.35 TB/s. It runs on the card only.

    python -m memory_augmented_vlm_torch.microbench.gemv --replays 300

also replays the chain's graph 300 times (`replays`): each replay's device
kernels, and its output against the eager chain's, bit for bit.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
from typing import NamedTuple

import torch

from memory_augmented_vlm_torch.microbench.timing import capture, graph_ms, require_card
from memory_augmented_vlm_torch.ops import cuda_lib

H, I, L = 896, 4864, 12  # tools_gemv_bench.py's shapes
PEAK_BYTES = 3.35e12  # H100 SXM, NVIDIA data sheet
STRIP_COLS = (128, 64, 32)  # a block's columns (256, 128 or 64 bytes of a W row), widest first
MAX_CLUSTER = 16  # blocks of a strip along K: the most a (non-portable) cluster holds
TILE_BYTES = 96 * 1024  # a block's W tile in shared memory, per pass over its slice
MAX_BOX_ROWS = 256  # TMA's largest box side


def _shapes(x: torch.Tensor, w: torch.Tensor):
    if x.dim() != 2 or x.shape[0] != 1 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemv takes (1, K) . (K, N), got {tuple(x.shape)} . {tuple(w.shape)}")
    return w.shape


def gemv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 product of the fp32 operands, cast to x's dtype."""
    _shapes(x, w)
    return (x.float() @ w.float()).to(x.dtype)


class Plan(NamedTuple):
    """The kernel's partition of one product: strips of `cols` columns, each
    the work of a cluster of `cluster` blocks along K; rank r sums rows r *
    rows .. (r + 1) * rows (the last rank's slice may end past K), in passes
    of `tile_rows` rows, each pass read as boxes of `box_rows` rows."""
    cols: int
    cluster: int
    rows: int
    tile_rows: int
    box_rows: int

    def strips(self, n: int) -> int:
        return -(-n // self.cols)

    def slices(self, k: int):
        """(start, end) of each rank's rows of K, in rank order."""
        return [(r * self.rows, min(k, (r + 1) * self.rows)) for r in range(self.cluster)]


def plan(k: int, n: int, sms: int) -> Plan:
    """The partition `gemv` launches for x (1, k) . W (k, n) on a card of
    `sms` SMs: the widest strip of STRIP_COLS whose strips, MAX_CLUSTER
    ranks each, can fill the SMs (else the narrowest);
    enough ranks per strip that strips x ranks fill the SMs (at most
    MAX_CLUSTER, at least 8 rows each), each rank's slice cut into passes
    of at most TILE_BYTES of W and each pass into at most MAX_BOX_ROWS-row
    boxes, rows rounded up to multiples of 8, and the ranks then cut to
    the fewest that cover k. A wider strip reads W in longer runs of a
    row; filling the SMs keeps the down product's 896 columns at 64
    (PERF.md §6)."""
    cols = next((c for c in STRIP_COLS if -(-n // c) * MAX_CLUSTER >= sms), STRIP_COLS[-1])
    strips = -(-n // cols)
    cluster = max(1, min(-(-sms // strips), MAX_CLUSTER, -(-k // 8)))
    per_rank = -(-k // cluster)
    passes = -(-per_rank // (TILE_BYTES // (2 * cols)))
    per_pass = -(-per_rank // passes)
    boxes = -(-per_pass // MAX_BOX_ROWS)
    box_rows = -(-(-(-per_pass // boxes)) // 8) * 8
    rows = passes * boxes * box_rows
    return Plan(cols, -(-k // rows), rows, boxes * box_rows, box_rows)


def gemv_in_kernel_order(x: torch.Tensor, w: torch.Tensor, pl: Plan) -> torch.Tensor:
    """The kernel's arithmetic in its order, on any device: for each rank
    of `pl`'s partition, a thread's fp32 sum over every RG-th row of each
    pass (RG = 256 / (cols / 8)), the row groups of a warp added pairwise
    as its shuffles add them, the 8 warps in order, then the ranks in
    order; rounded once to bf16. A bf16 x bf16 product is exact in fp32,
    so the kernel's FMA and this multiply-then-add round alike (unless a
    product falls below fp32's normal range)."""
    k, n = _shapes(x, w)
    tpr = pl.cols // 8
    rg, ncols = 256 // tpr, pl.strips(n) * pl.cols
    padded = pl.cluster * pl.rows
    wf = torch.zeros((padded, ncols), dtype=torch.float32, device=w.device)
    wf[:k, :n] = w.float()
    xf = torch.zeros((padded, 1), dtype=torch.float32, device=x.device)
    xf[:k, 0] = x[0].float()
    prod = (xf * wf).view(pl.cluster, pl.rows // pl.tile_rows, pl.tile_rows, ncols)
    acc = torch.zeros((pl.cluster, rg, ncols), dtype=torch.float32, device=w.device)
    for ps in range(prod.shape[1]):
        for r0 in range(0, pl.tile_rows, rg):
            step = prod[:, ps, r0:r0 + rg]
            acc[:, :step.shape[1]] = acc[:, :step.shape[1]] + step
    acc = acc.view(pl.cluster, 8, 32 // tpr, ncols)  # (rank, warp, group of the warp, column)
    while acc.shape[2] > 1:
        acc = acc[:, :, 0::2] + acc[:, :, 1::2]
    ranks = acc[:, 0, 0]
    for wp in range(1, 8):
        ranks = ranks + acc[:, wp, 0]
    y = ranks[0]
    for r in range(1, pl.cluster):
        y = y + ranks[r]
    return y[None, :n].to(x.dtype)


def loads_by_tma(w: torch.Tensor) -> bool:
    """Whether the kernel reads W by TMA: its row stride (2 N bytes) and its
    base 16-byte aligned. Else plain loads, in the same kernel."""
    return w.shape[1] % 8 == 0 and w.data_ptr() % 16 == 0


def gemv(x: torch.Tensor, w: torch.Tensor, *, overlap: bool = False) -> torch.Tensor:
    """x (1, K) bf16; w (K, N) bf16 row-major. Returns (1, N) bf16. CPU
    tensors take the plain version; CUDA tensors launch the kernel (any K
    and N; contiguous operands; one launch, partitioned by `plan`) and
    count one launch in `gemv.launches`. `overlap` launches it as a
    programmatic dependent of the grid launched just before it on the
    stream: it starts while that grid runs and reads w before that grid
    has ended, so w must not be that grid's output; only `chain` passes
    it, for the products whose grid before is the chain's previous
    product."""
    k, n = _shapes(x, w)
    if x.device.type == "cpu":
        return gemv_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gemv runs on cpu or cuda, not {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemv kernel takes bf16, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemv kernel takes contiguous operands")
    if k == 0:
        return torch.zeros((1, n), dtype=x.dtype, device=x.device)
    out = torch.empty((1, n), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    pl = plan(k, n, torch.cuda.get_device_properties(x.device).multi_processor_count)
    lib = cuda_lib.load()
    rc = lib.gemv_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(), k, n, pl.cols, pl.cluster,
                       pl.rows, pl.tile_rows, pl.box_rows, int(loads_by_tma(w)), int(overlap),
                       torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(lib, rc, "gemv_bf16")
    gemv.launches += 1
    return out


gemv.launches = 0


def operands(seed: int = 0, device="cuda"):
    """The tool's operands on `device`: x (1, H) ~ N(0, 0.1^2), W1 (L, H, I)
    and W2 (L, I, H) ~ N(0, 0.02^2), all bf16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(torch.bfloat16)

    return randn(1, H, std=0.1), randn(L, H, I, std=0.02), randn(L, I, H, std=0.02)


def chain(fn, x, w1, w2):
    """The tool's chain: y = fn(x, W1[l]); x = fn(y, W2[l]) over the layers.
    With fn = `gemv`, every product after the first overlaps the one before
    it (`overlap=True`): that product writes only its own output, and the
    weights were written before the chain began."""
    step = fn
    for l in range(w1.shape[0]):
        for w in (w1[l], w2[l]):
            x = step(x, w)
            if fn is gemv:
                step = functools.partial(gemv, overlap=True)
    return x


def chain_bytes(x, w1, w2) -> int:
    """Bytes one chain must move: every weight and every vector read once,
    every output written once."""
    layers, h, i = w1.shape
    return layers * (2 * h * i + 2 * (h + i)) * x.element_size()


def measure(x, w1, w2) -> dict:
    """ms per chain, GB/s and share of the memory rate, for the kernel and
    for torch.matmul, each replayed from a CUDA graph."""
    nbytes = chain_bytes(x, w1, w2)
    rows = {}
    for name, fn in (("kernel", gemv), ("torch.matmul", torch.matmul)):
        ms = graph_ms(lambda fn=fn: chain(fn, x, w1, w2))
        rows[name] = {"ms_per_chain": ms, "gb_per_s": nbytes / ms / 1e6,
                      "share_of_memory_rate": nbytes / ms / 1e-3 / PEAK_BYTES}
    return {"layers": w1.shape[0], "shape": list(w1.shape[1:]), "mb_per_chain": nbytes / 1e6,
            "timing": "one chain replayed from a CUDA graph, weights 4x the L2", **rows}


def replays(x, w1, w2, n: int, seed: int = 1) -> dict:
    """`n` replays of one CUDA graph of the kernel chain, each on a new x
    (seeded N(0, 0.1^2), copied into the graph's input): per replay, the
    device kernels named gemv that torch.profiler records, and whether the
    chain's output equals the eager chain's on that x bit for bit. A launch
    lost from a replay leaves its output, or a later product's input, as
    the previous replay wrote it, so the output differs; a record the
    profiler dropped leaves the output equal."""
    static_x = x.clone()
    held = {}

    def run():
        held["out"] = chain(gemv, static_x, w1, w2)

    graph = capture(run)  # the graph's output is the capture's `out`
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts, differing = collections.Counter(), []
    for i in range(n):
        xi = (torch.randn(x.shape, generator=gen, device=x.device) * 0.1).to(x.dtype)
        want = chain(gemv, xi, w1, w2)
        static_x.copy_(xi)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            graph.replay()
            torch.cuda.synchronize()
        counts[sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "gemv" in e.name)] += 1
        if not torch.equal(held["out"], want):
            differing.append(i)
    return {"replays": n, "device_kernels_per_replay": dict(sorted(counts.items())),
            "want": 2 * w1.shape[0], "replays_whose_output_differs": differing}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--replays", type=int, default=0,
                   help="also replay the chain's graph this many times, counting each "
                        "replay's device kernels and holding its output to the eager chain's")
    args = p.parse_args(argv)
    card = require_card()
    print(card)
    operands_ = operands()
    print(json.dumps({"gemv": measure(*operands_)}))
    if args.replays:
        print(json.dumps({"gemv_chain_replays": replays(*operands_, args.replays)}))


if __name__ == "__main__":
    main()
