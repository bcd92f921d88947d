"""Traffic for the benchmark's cells, generated from ``--seed``: a frozen
copy of the scripted PointNav world (circular textured rooms, ray-cast
depth, actuation noise, the greedy goal rule) that renders a seeded bank
of trajectories, and the general generator that turns a traffic file into
the frames, actions and batches a cell feeds the program."""
