"""Published peaks of the card, in one place.

NVIDIA H100 Tensor Core GPU data sheet, SXM5 part (H100 80GB HBM3), dense
rates without sparsity, at the full 700 W power limit: 1,979 TOP/s int8 on
the tensor cores, the card's densest published rate, and 3.35 TB/s of HBM3
bandwidth.  A card set below 700 W runs slower under load; every result
line carries the card's name and each run's PERF.md entry its power limit.
"""

SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, H100 SXM: 1,979 TOPS int8 "
          "dense, 3.35 TB/s HBM3, 700 W")

INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core operations a second
HBM_BYTES_PER_S = 3.35e12      # HBM3 bytes a second
POWER_LIMIT_W = 700.0          # the power limit the rates assume
