"""Host seconds of ``sfvp_tpu_torch.kernels.build.library()``, called once
before the Renderer is built: nvcc on a checkout's first run, a load of
the cached library after."""


def read(rec):
    return rec.kernel_load_s
