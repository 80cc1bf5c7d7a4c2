"""The mean-scale hyperprior family's train and itinf entry points."""
