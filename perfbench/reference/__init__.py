"""Plain PyTorch forwards of each family, written from the configuration's
file, in float32 (TF32 off) or, as the control, with every product's
operands rounded to float8 (e4m3).  They import nothing of the program
and read only the benchmark's own weights and token ids."""
import importlib


def forward(family: str):
    """The ``logits`` function of family ``family``'s reference."""
    return importlib.import_module(f"perfbench.reference.{family}").logits
