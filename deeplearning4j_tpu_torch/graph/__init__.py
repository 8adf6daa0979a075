"""Graph API, random walks and DeepWalk — port of deeplearning4j_tpu/graph/."""
