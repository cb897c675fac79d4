from repro_torch.kernels.spmv.ops import spmv

__all__ = ["spmv"]
