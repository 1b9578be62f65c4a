"""satdump_tpu_torch — the PyTorch/CUDA port of satdump_tpu.

The same data-level contract as the JAX package beside it:

    baseband (IQ) -> soft (int8 soft symbols) -> cadu (FEC-decoded frames)
        -> products (instrument images, dataset.json, composites)

Tensor code is plain PyTorch; the two hot kernels of the main path (the
register-exchange Viterbi and the arithmetic-grid polyphase resampler) are
hand-written CUDA C++ for sm_90a under ``csrc/``, built with nvcc at first
use and bound with ctypes (``ops/cuda/``). Every op dispatches on the
device of the tensor it is given: a CUDA tensor goes to the hand kernel, a
CPU tensor to the plain PyTorch version beside it. Entry points run on
``cuda`` unless the caller asks for the CPU (``device=`` on functions and
classes, ``torch_device`` on pipeline modules).

Subpackages mirror satdump_tpu's layout:
  core      config / logging / registry / events / HTTP status / tasks /
            webhook / boot (init_satdump)
  io        baseband file formats, the remote-IQ protocol, sample
            sources, frame fan-in, UDP discovery
  ops       DSP + FEC ops (plain torch) and the CUDA kernel wrappers
  ccsds     Space Packet demux (host)
  geo       TLE, SGP4, geodetic transforms, raytracers and GCPs, the
            thin-plate-spline warps (the spline on the device), map
            projections, reprojection, shapefile / GeoJSON, IERS, SPK
  tracking  pass prediction, Doppler, the AutoTrack scheduler, rotctld
  models    instrument modules: MetOp AHRPT, METEOR MSU-MR LRPT
  products  products, calibrators, the products processor, first-party
            ingest (SEVIRI .nat, Himawari HSD, netCDF / HDF5)
  image     PNG codec, composite expressions, post ops, MSU-MR's IDCT,
            map overlays, text (a bitmap font of its own), GeoTIFF
  pipeline  JSON pipeline engine, the ported processing modules, the live
            pipeline and its multi-VFO front end
  utils     device selection, state conversion, bit repacking, CBOR,
            BitView, MPEG-TS, MQTT
"""

__version__ = "0.1.0"

from satdump_tpu_torch.core.config import Config, get_config  # noqa: F401
from satdump_tpu_torch.core.log import logger  # noqa: F401
