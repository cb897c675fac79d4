from repro_torch.graphs.generate import generate_edges, rmat_edges, \
    smallworld_edges, urand_edges

__all__ = ["generate_edges", "rmat_edges", "smallworld_edges",
           "urand_edges"]
