"""The port's counterparts of the repository's ``examples/`` scripts."""
