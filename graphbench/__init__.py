"""The benchmark of the PyTorch/CUDA port (``repro_torch``): BFS and
PageRank over generated graphs cut into P vertex blocks, on one card.
``python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; see README.md."""
