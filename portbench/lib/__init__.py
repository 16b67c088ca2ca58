"""The yardstick's shared pieces: spec loading, statistics, tracing,
weights, the serve loops and the correctness comparison."""
