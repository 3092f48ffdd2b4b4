"""The benchmark's own machinery: cell lookup, weights and traffic from the
seed, the serving and training drivers, the profiler's reduction and the
yardstick arithmetic (operations, bytes, peaks)."""
