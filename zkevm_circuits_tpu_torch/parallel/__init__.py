"""The multi-device layer on torch.distributed: one process a card (NCCL),
or one process a CPU rank (gloo) when the CPU is named.

    mesh.py     the world (`init_world`, `run_world`) and the 2-D mesh
    sharded.py  the hand-scheduled row-sharded ram_permutation check
    prover.py   the sharded STARK commit (column LDE, all-to-all, row Merkle)
    auto.py     row-sharded evaluation of any circuit with a shard plan
"""
