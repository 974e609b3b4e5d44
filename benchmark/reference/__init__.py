"""Plain PyTorch references of what the benchmark's cells compute.

Each module is written from the published definitions (term reveal, HESE
digit planes, the two-phase calibration, ResNet-18, the LSTM LM) in
float32 with no kernel, cache or batching trick, and imports nothing of
the program under test: the harness checks the program's outputs against
them.  ``precision.round_tf32`` gives each of them its lower-precision
twin, the control that the check has to reject.
"""
