"""Which GEMM calls take ``matmul.cu``'s wgmma path: cases for the CPU test
of ``kernel.wgmma_path`` and for the card tests of the C entry's choice.
Each is ((m, n, k), (block_m, block_n, block_k), bases 16-byte aligned,
takes the path).  This module imports neither JAX nor torch."""

WGMMA_CASES = [
    ((2048, 2048, 2048), (128, 128, 128), True, True),
    ((2048, 2048, 2048), (256, 256, 128), True, True),     # 4 splits
    ((2048, 2048, 2048), (512, 512, 1024), True, True),    # 2 splits
    ((1000, 1000, 1000), (128, 128, 128), True, True),     # ragged, 4 splits
    ((130, 4100, 36), (128, 128, 128), True, True),        # K inside a chunk
    ((16, 4096, 4096), (128, 128, 128), True, False),      # M < 128
    ((4096, 16, 4096), (128, 128, 128), True, False),      # N < 128
    ((1000, 1000, 1001), (128, 128, 128), True, False),    # K % 4 != 0
    ((2048, 2048, 2048), (64, 128, 128), True, False),     # 64-wide sub-tile
    ((2048, 2048, 2048), (128, 64, 128), True, False),
    ((2048, 2048, 2048), (128, 128, 128), False, False),   # base off 16 bytes
    ((128, 128, 200), (128, 128, 8), True, False),         # splits of 8 deep
]


def case_id(case) -> str:
    (m, n, k), (bm, bn, bk), aligned, _ = case
    return f"{m}x{n}x{k}-{bm}-{bn}-{bk}" + ("" if aligned else "-unaligned")
