"""The evaluation side of the JAX package's ``training/``: normalization
parameters and batch selection (``helper.py``) and the validation step
(``steps.py``). The training loops are not ported yet."""
