"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates) that the
rooflines are held to. They assume the card's full 700 W power limit; a run
states the limit its card had beside every share."""

HBM_BYTES_PER_S = 3.35e12         # HBM3
F32_FLOPS = 67e12                 # float32 outside the tensor cores
# the same units issue one add, compare or select where they issue one FMA
# (two flops), so operations that are not FMAs run at half the flop rate
F32_OPS = F32_FLOPS / 2
