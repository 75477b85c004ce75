"""Models of the port: the dense attention decoder of the paper's GPT,
forward and decode, with the JAX package's parameter keys."""
