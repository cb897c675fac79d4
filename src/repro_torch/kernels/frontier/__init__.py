from repro_torch.kernels.frontier.ops import frontier_pull

__all__ = ["frontier_pull"]
