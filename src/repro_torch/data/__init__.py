from repro_torch.data.tokens import TokenStream, batch_at

__all__ = ["TokenStream", "batch_at"]
