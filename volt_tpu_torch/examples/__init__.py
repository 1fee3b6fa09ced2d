"""Runnable walkthroughs of the port, one module per script of the JAX
package's ``examples/``: ``python -m volt_tpu_torch.examples.<name>``
(``--device cpu`` off the card; a figure only under ``--plot PATH``, which
needs matplotlib).  Each module's ``main(argv)`` takes the command line
as a list."""
