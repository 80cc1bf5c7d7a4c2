"""The factorized-prior family's train and itinf entry points."""
