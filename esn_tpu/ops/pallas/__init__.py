"""Hand-written Pallas kernels, each beside the plain reference it is
tested against. A kernel stays only while it beats what XLA compiles from
the plain version, end to end on the card."""
