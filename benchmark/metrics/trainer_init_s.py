"""Host set-up of the program, seconds: the port's dataset from the run's
arrays and its BFS relabelling (data/loaders.py reorder_bfs), the Trainer
(the CSR graphs, host A^2 of the train and train+valid graphs, edge
positions, the dual-K plan; sparse/build.py, Trainer.__init__) and
init_state; the eval cell adds epoch 1's window tables."""
UNIT = "s"


def read(ctx):
    return ctx["spans"]["trainer_init_s"]
