"""Launch: the serving CLI and the continuous-batching scheduler."""
