"""The tensor-parallel layers, the pipeline layer descriptions and the
model-parallel RNG tracker."""
