"""The plain reference that decides `correct`: plain fp32 PyTorch models
(one module per configuration's `reference`), the weight reader and the
plain segmenter. Imports nothing of the program."""
