"""The paper's experiments on the port: one module per main of the JAX
package's ``benchmarks/`` (and ``examples/plan_deployment.py``), with the
same settings, tables and asserted claims.  The live mains run on
``cuda`` unless the caller passes ``device="cpu"``."""
