"""The GNN family: ``mace`` (the model) and ``sampler`` (the host-side
neighbour sampler of the minibatch cell)."""
