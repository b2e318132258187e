"""The plain reference of the keyframe-to-labelled-map path.

Plain PyTorch and NumPy, after the reference C++ node
(VisualComputingInstitute/RovinaSemanticSegmentation): ``frame.py`` (8-bit
Lab, depth-adaptive patches, depth, height and normal-angle features, the
forest's descent and leaf-histogram sum, bilinear resize and argmax),
``fusion.py`` (z-buffered projection of a map into keyframes and the fused
unaries, plain argmax labels) and ``lattice.py`` (permutohedral lattice,
Potts mean field, labels with the 2/C floor). It imports nothing of the port
and takes nothing the port made: it reads the raw inputs and the forest
file and works out everything else again.

Every float stage takes a dtype: float32 is the configuration's precision;
bfloat16 gives the control that the comparison must reject.
"""
