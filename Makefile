# Build/test/deploy targets (parity with the reference's kubebuilder Makefile
# test/docker-build/deploy surface, Makefile:96-165).

IMG_OPERATOR ?= datatunerx-tpu/operator:latest
IMG_TRAINER  ?= datatunerx-tpu/trainer:latest
# the PyTorch/CUDA port's images, as its control plane names them
# (operator/install.OPERATOR_IMAGE, operator/config.get_base_image)
IMG_OPERATOR_CUDA ?= datatunerx-tpu/operator-cuda:latest
IMG_TRAINER_CUDA  ?= datatunerx-tpu/trainer-cuda:latest

.PHONY: test test-fast native native-torch bench graft-check aot-certify docker-build docker-build-torch deploy undeploy fmt lint lint-fix

test:            ## full test suite (8-device virtual CPU mesh)
	python -m pytest tests/ -q

lint:            ## dtxlint: program-level JAX-aware static analysis (the tier-1 CI gate)
	python -m datatunerx_tpu.analysis datatunerx_tpu/ scripts/ bench.py __graft_entry__.py

lint-fix:        ## apply dtxlint's mechanical autofixes (DTX002/DTX008), then re-lint
	python -m datatunerx_tpu.analysis datatunerx_tpu/ scripts/ bench.py __graft_entry__.py --fix

test-fast:       ## skip the slow live-pipeline e2e
	python -m pytest tests/ -q -m "not slow"

native:          ## build the C++ data-path extension
	python -c "from datatunerx_tpu import native; assert native.available(); print('native OK')"

native-torch:    ## the port's builds: its CUDA kernel library (nvcc, no card needed) and its C++ packer
	python -m datatunerx_tpu_torch.ops._build
	python -c "from datatunerx_tpu_torch import native; assert native.available(); print('native OK')"

bench:           ## headline benchmark (one JSON line)
	python bench.py

graft-check:     ## driver contract: entry() + dryrun_multichip(8)
	python scripts/graft_check.py

aot-certify:     ## deviceless Mosaic/XLA-TPU compile certification (v5e)
	python scripts/aot_certify.py

docker-build:    ## operator + trainer images
	docker build -t $(IMG_OPERATOR) -f Dockerfile .
	docker build -t $(IMG_TRAINER) -f Dockerfile.trainer .

docker-build-torch: ## the port's operator + trainer/serving images (CUDA)
	docker build -t $(IMG_OPERATOR_CUDA) -f Dockerfile.torch .
	docker build -t $(IMG_TRAINER_CUDA) -f Dockerfile.torch-trainer .

deploy:          ## apply operator manifests to the current cluster
	kubectl apply -f deploy/crds/ -f deploy/rbac.yaml -f deploy/operator.yaml

undeploy:
	kubectl delete -f deploy/operator.yaml -f deploy/rbac.yaml

fmt:
	python -m compileall -q datatunerx_tpu
