"""The graph families, one file a family: ``generators/<name>.py``'s
``make(cfg, n, e, gen, device)`` draws ``e`` directed edges on ``n``
vertices from the generator ``gen``, in plain torch, on ``device``."""
