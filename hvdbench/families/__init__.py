"""One module a model family: its leaves and how they are drawn, its
inputs from the seed, the program's model and loss, and its FLOP count.
A module here imports the program only inside the functions that build
the program's side."""
