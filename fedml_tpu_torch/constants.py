"""Platform / backend / federated-optimizer constants of the PyTorch port.

A copy of ``fedml_tpu/constants.py`` with the same string values, so YAML
configs written for either package keep working.  ``XLA`` names the in-mesh
round simulator; in the port it selects the same padded FedAvg round, run
as a loop over the sampled clients on one CUDA card.
"""

# ---------------------------------------------------------------------------
# Training platforms (reference: python/fedml/constants.py:1-11)
# ---------------------------------------------------------------------------
FEDML_TRAINING_PLATFORM_SIMULATION = "simulation"
FEDML_TRAINING_PLATFORM_CROSS_SILO = "cross_silo"
FEDML_TRAINING_PLATFORM_CROSS_DEVICE = "cross_device"
FEDML_TRAINING_PLATFORM_DISTRIBUTED = "distributed"

FEDML_TRAINING_PLATFORM_CROSS_SILO_TYPE = 1
FEDML_TRAINING_PLATFORM_SIMULATION_TYPE = 2
FEDML_TRAINING_PLATFORM_DISTRIBUTED_TYPE = 3
FEDML_TRAINING_PLATFORM_CROSS_DEVICE_TYPE = 4

# ---------------------------------------------------------------------------
# Cross-silo scenarios (reference: constants.py:13-15)
# ---------------------------------------------------------------------------
FEDML_CROSS_SILO_SCENARIO_HORIZONTAL = "horizontal"
FEDML_CROSS_SILO_SCENARIO_HIERARCHICAL = "hierarchical"

# ---------------------------------------------------------------------------
# Simulation backends. The reference ships sp / MPI / NCCL
# (constants.py:17-20); this framework's native backend is XLA: simulated
# clients are sharded over a jax.sharding.Mesh and aggregated with in-program
# collectives (lax.psum) over ICI.  "sp", "MPI" and "NCCL" configs are accepted
# and routed to the closest native equivalent (sp -> SP loop; MPI/NCCL -> XLA).
# ---------------------------------------------------------------------------
FEDML_SIMULATION_TYPE_SP = "sp"
FEDML_SIMULATION_TYPE_MPI = "MPI"
FEDML_SIMULATION_TYPE_NCCL = "NCCL"
FEDML_SIMULATION_TYPE_XLA = "XLA"

# Host-side message-plane backends (cross-silo / cross-device).
FEDML_BACKEND_LOOPBACK = "LOOPBACK"
FEDML_BACKEND_GRPC = "GRPC"
FEDML_BACKEND_MQTT_S3 = "MQTT_S3"
FEDML_BACKEND_MQTT_S3_MNN = "MQTT_S3_MNN"
FEDML_BACKEND_TRPC = "TRPC"
FEDML_BACKEND_MPI = "MPI"

# ---------------------------------------------------------------------------
# Data cache
# ---------------------------------------------------------------------------
FEDML_DATA_CACHE_FOLDER = "fedml_data"

# ---------------------------------------------------------------------------
# Federated optimizers (reference: constants.py:27-47, same strings)
# ---------------------------------------------------------------------------
FedML_FEDERATED_OPTIMIZER_BASE_FRAMEWORK = "base_framework"
FedML_FEDERATED_OPTIMIZER_FEDAVG = "FedAvg"
FedML_FEDERATED_OPTIMIZER_FEDOPT = "FedOpt"
FedML_FEDERATED_OPTIMIZER_FEDPROX = "FedProx"
FedML_FEDERATED_OPTIMIZER_CLASSICAL_VFL = "classical_vertical"
FedML_FEDERATED_OPTIMIZER_SPLIT_NN = "split_nn"
FedML_FEDERATED_OPTIMIZER_DECENTRALIZED_FL = "decentralized_fl"
FedML_FEDERATED_OPTIMIZER_FEDGAN = "FedGAN"
FedML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST = "FedAvg_robust"
FedML_FEDERATED_OPTIMIZER_FEDAVG_SEQ = "FedAvg_seq"
FedML_FEDERATED_OPTIMIZER_FEDOPT_SEQ = "FedOpt_seq"
FedML_FEDERATED_OPTIMIZER_FEDGKT = "FedGKT"
FedML_FEDERATED_OPTIMIZER_FEDNAS = "FedNAS"
FedML_FEDERATED_OPTIMIZER_FEDSEG = "FedSeg"
FedML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE = "turbo_aggregate"
FedML_FEDERATED_OPTIMIZER_FEDNOVA = "FedNova"
FedML_FEDERATED_OPTIMIZER_HIERACHICAL_FL = "HierarchicalFL"
FedML_FEDERATED_OPTIMIZER_FEDSGD = "FedSGD"
FedML_FEDERATED_OPTIMIZER_FEDLOCALSGD = "FedLocalSGD"
FedML_FEDERATED_OPTIMIZER_ASYNC_FEDAVG = "Async_FedAvg"
FedML_FEDERATED_OPTIMIZER_FEDDYN = "FedDyn"
FedML_FEDERATED_OPTIMIZER_SCAFFOLD = "SCAFFOLD"
FedML_FEDERATED_OPTIMIZER_MIME = "Mime"
# decentralized multi-task GNN (reference research/SpreadGNN)
FedML_FEDERATED_OPTIMIZER_SPREADGNN = "SpreadGNN"

# ---------------------------------------------------------------------------
# TPU mesh-axis naming conventions (native additions).
#   client: simulated-FL client data parallelism (Parrot-XLA)
#   dp/fsdp: batch data parallelism inside one silo ("Cheetah")
#   tp: tensor parallelism; sp: sequence/context parallelism (ring attention)
#   pp: pipeline stages; ep: expert parallelism
# ---------------------------------------------------------------------------
MESH_AXIS_CLIENT = "client"
MESH_AXIS_DP = "dp"
MESH_AXIS_FSDP = "fsdp"
MESH_AXIS_TP = "tp"
MESH_AXIS_SP = "sp"
MESH_AXIS_PP = "pp"
MESH_AXIS_EP = "ep"

# FedProx default proximal term when the optimizer is selected without an
# explicit mu (shared by every backend so configs train the same objective)
FEDPROX_DEFAULT_MU = 0.1
