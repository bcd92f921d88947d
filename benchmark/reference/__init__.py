"""Plain PyTorch reference of what the benchmark's cells time: the GroupNorm
ResNets, the VO CNN with its whitening, the depth features and the
top-down projection (a scatter-add), goal propagation and drift, the
ResNet + LSTM policy, and the VO training step (loss with the invariance
term, Adam).  Frozen copies written from the published model description;
they import nothing of the port."""
