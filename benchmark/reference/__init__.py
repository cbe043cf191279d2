"""The plain reference the cells' outputs are judged against: Hex (`hex`),
the networks (`nets`), the search (`mcts`) and the train step (`learner`), in
plain PyTorch. It imports nothing of the program and takes nothing the
program made: the benchmark hands it the same weights, draws and inputs."""
