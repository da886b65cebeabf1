"""Target-hardware constants (NVIDIA H100 SXM) used by the roofline analysis.

Port of ``repro.launch.hw``, whose constants are a TPU v5e's.  The rates
are data-sheet peaks, not measurements: NVIDIA's H100 SXM data sheet, dense
(no sparsity), at the card's full 700 W power limit; a card set below it
runs slower under load.  ``HBM_BYTES`` is what the card reports.
"""

# bf16 (and fp16) tensor-core FLOP/s, dense (H100 SXM data sheet)
PEAK_FLOPS = 989e12
# float32 FLOP/s outside the tensor cores (H100 SXM data sheet)
F32_FLOPS = 67e12
# HBM3 bytes/s (H100 SXM data sheet, 3.35 TB/s)
HBM_BW = 3.35e12
# NVLink 4 bytes/s per direction between two cards (H100 SXM data sheet:
# 900 GB/s bidirectional); the counterpart of the reference's ICI_BW
LINK_BW = 450e9
# device memory: torch.cuda.get_device_properties(0).total_memory on an
# "NVIDIA H100 80GB HBM3" at a 700 W limit (read on the card, not a
# data-sheet figure: the 80 GiB of HBM, 85.9e9 B, less what the card
# reserves)
HBM_BYTES = 85_017_493_504
