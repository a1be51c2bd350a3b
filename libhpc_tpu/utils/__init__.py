from libhpc_tpu.utils.config import RadixConfig  # noqa: F401
