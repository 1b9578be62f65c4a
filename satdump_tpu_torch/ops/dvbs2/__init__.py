"""DVB-S2 (EN 302 307-1) receive/transmit chain — port of
satdump_tpu/ops/dvbs2.

Reference behavior: plugins/dvb_support/dvbs2/ (PL sync, pilot PLL, soft
demap, demod module) and plugins/dvb_support/codings/dvb-s2/ (LDPC, BCH,
descramblers). Whole PLFRAMEs are processed as arrays (frames in lanes):
the PL header search is one differential-correlation pass over the block
and the PL layer, BCH and the scramblers are host NumPy copies of the JAX
package's; the soft demap and the LDPC min-sum run in torch on the device
they are given.
"""
