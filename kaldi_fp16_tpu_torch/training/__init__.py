"""Training: SGD with momentum and max-change, loss scaling, the
semi-orthogonal constraint, and the chain train step."""
