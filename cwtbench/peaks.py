"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, at
its 700 W power limit).  A roofline share is stated against these, with
the card's name beside it in the result line."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
#: float32 outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
