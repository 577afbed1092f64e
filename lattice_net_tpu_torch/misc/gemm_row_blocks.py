"""Whether row blocks of a bf16 GEMM give the whole GEMM's rows bit for bit.

    python -m lattice_net_tpu_torch.misc.gemm_row_blocks

The row-chunked conv (``lattice/ops._conv_fwd``) runs a conv whose patch
would pass ``LNT_CONV_CHUNK_BYTES`` as one GEMM a row block; its output
equals the one-block conv's bit for bit only where ``torch.mm`` gives a
block of rows exactly as it gives them inside the whole product.  For the
widest ScanNet eval convs at the 5M-row tables (random bf16 patches, f32
out), this prints per shape how many blocks are bit-equal, and how far a
split of the same product into neighbour and centre columns (two GEMMs
added) lies from it.  Runs on the card only.
"""

from __future__ import annotations

import torch

from lattice_net_tpu_torch.lattice.ops import _conv_row_blocks, _row_blocks

SHAPES = ((5_000_000, 128, 96), (2_500_000, 192, 64), (625_000, 256, 128), (5_000_000, 32, 32))


def main():
    torch.manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for cq, c, c_out in SHAPES:
        a = torch.randn(cq, 9 * c, device="cuda").to(torch.bfloat16)
        w = (torch.randn(9 * c, c_out, device="cuda") * 0.05).to(torch.bfloat16)
        whole = torch.mm(a, w, out_dtype=torch.float32)
        blocks = _row_blocks(cq, _conv_row_blocks(cq, 9, c, 2))
        equal, split = 0, 0.0
        for r0, r1 in blocks:
            equal += int(torch.equal(torch.mm(a[r0:r1], w, out_dtype=torch.float32), whole[r0:r1]))
            two = torch.mm(a[r0:r1, : 8 * c], w[: 8 * c], out_dtype=torch.float32)
            two += torch.mm(a[r0:r1, 8 * c :], w[8 * c :], out_dtype=torch.float32)
            split = max(split, (two - whole[r0:r1]).abs().max().item())
        print(f"cq={cq} C={c} C_out={c_out}: {equal}/{len(blocks)} blocks bit-equal to the whole GEMM; "
              f"two-GEMM split max abs diff {split:.3e}", flush=True)  # fmt: skip
        del a, whole


if __name__ == "__main__":
    main()
