#!/bin/bash
# The four-card mesh train and serve cases of another checkout (PARENT,
# e.g. a `git archive` of the parent commit unpacked under build/) and of
# this one, in turns: parent, change, change, parent. Reports go to
# OUT/cmp_{parent,new}{1,2}.json. Needs four cards:
#   bash tools/mesh_serve_cmp.sh build/parent OUT
set -e
parent=${1:?usage: mesh_serve_cmp.sh PARENT_CHECKOUT OUT_DIR}
out=${2:?usage: mesh_serve_cmp.sh PARENT_CHECKOUT OUT_DIR}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p "$out"
run() {  # src-dir test-file out
  PYTHONPATH=$1 python3 -m torch.distributed.run --standalone \
    --nproc-per-node 4 tools/mesh_serve_cmp.py "$2" "$3" \
    > "$3.log" 2>&1 || { tail -c 4000 "$3.log"; exit 1; }
}
pt=$parent/tests/test_torch_cuda_lm_mesh.py
run "$parent/src" "$pt" "$out/cmp_parent1.json"
run src tests/test_torch_cuda_lm_mesh.py "$out/cmp_new1.json"
run src tests/test_torch_cuda_lm_mesh.py "$out/cmp_new2.json"
run "$parent/src" "$pt" "$out/cmp_parent2.json"
