"""Local optimizers (the port of ``src/repro/optim``).

The paper's LEAD uses the raw stochastic gradient (SGD) in lines 4/7.  For
neural-net training momentum and Adam are offered as local
preconditioners: the optimizer transforms the local gradient g -> u and the
algorithm treats u as its "gradient" (plain SGD is the paper-faithful
path).
"""
from repro_torch.optim.optimizers import Adam, Momentum, SGD, make_optimizer
