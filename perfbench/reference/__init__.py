"""The plain reference: the models' loss and gradients, the FedSGD step,
Eq. 1, Eq. 2, the BTSV tally and the chain's checks, in plain PyTorch
(float32, TF32 off) and Python. It imports neither ``jax`` nor the JAX
package nor the program (``repro_torch``), and takes nothing the program
made: the benchmark hands it the same weights and batches it hands the
program, and the program's outputs only to judge them."""
