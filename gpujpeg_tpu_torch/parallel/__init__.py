"""parallel subpackage: device meshes, batch and stripe coding, multi-process
routing (gpujpeg_tpu.parallel)."""
