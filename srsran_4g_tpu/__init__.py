"""srsran_4g_tpu — an accelerator-native LTE PHY signal-processing framework.

A brand-new JAX/XLA/Pallas implementation of the LTE downlink/uplink physical
layer with the capabilities of srsRAN_4G's PHY library (reference:
lib/src/phy of srsRAN_4G), running on a GPU (the CPU serves the tests):

- batched, static-shape kernels (batch dim = subframes / transport blocks / UEs)
- gathers with precomputed device-resident index tensors instead of scalar loops
- `lax.scan`/`lax.associative_scan` for trellis/LFSR recursions
- GF(2) linear algebra (CRC, encoders) as float matmuls, exact for 0/1
- sharding via `jax.sharding.Mesh` + `shard_map`, halo exchange via `ppermute`

Subpackage map (≈ reference directory in parentheses):
  utils/     constants, bit manipulation            (lib/src/phy/common, utils)
  ops/       DSP kernels: ofdm, modem, crc, turbo,  (lib/src/phy/{dft,modem,fec,
             scrambling, rate matching, sequence     scrambling,common})
  models/    composite channel processors: SCH,     (lib/src/phy/{phch,ch_estimation,
             PDSCH, chest, equalizer, resource grid  mimo,ue,enb})
  channel/   channel emulator: AWGN, fading, RLF    (lib/src/phy/channel)
  parallel/  mesh/sharding, sharded pipelines       (reference: pthread pipeline,
                                                     SURVEY.md §2.7)
"""

__version__ = "0.1.0"
