"""The plain PyTorch references, one file per model family.  Nothing here
imports the program."""
