"""Plain PyTorch references of what the benchmark's cells run.

Written from the published architecture (Real-ESRGAN's RRDBNet), over
state dicts the benchmark drew itself. They import nothing of the program
under test and run in float32 with TF32 off unless a control asks for a
lower precision (`lowprec`)."""
