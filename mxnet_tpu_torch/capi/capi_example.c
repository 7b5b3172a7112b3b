/*
 * Minimal C host for the full graph ABI (c_api_graph.h): builds an MLP
 * symbol through the two-phase create+compose protocol, infers shapes,
 * binds an executor, runs forward+backward, and applies one SGD step via
 * the KVStore with a C updater callback. This is what an external binding
 * (reference scala-package/native, R-package/src) would do.
 *
 * Built by mxnet_tpu_torch.capi.build_example("capi_example"); run as
 * capi_example [dev_type [dev_id]].
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "c_api_graph.h"

#define CHECK(x)                                                      \
  do {                                                                \
    if ((x) != 0) {                                                   \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__,         \
              MXTApiGetLastError());                                  \
      exit(1);                                                        \
    }                                                                 \
  } while (0)

/* the device: argv[1] dev_type (2 cuda:dev_id, the default; 1 the host),
 * argv[2] dev_id */
static int g_dev_type = 2, g_dev_id = 0;

static SymbolHandle atomic(const char *op, const char *name,
                           unsigned nparam, const char **pk,
                           const char **pv, unsigned nin,
                           const char **ik, SymbolHandle *iv) {
  SymbolHandle h;
  CHECK(MXTSymbolCreateAtomicSymbol((AtomicSymbolCreator)op, nparam, pk, pv,
                                    &h));
  CHECK(MXTSymbolCompose(h, name, nin, ik, iv));
  return h;
}

static NDArrayHandle nd_new(const mx_uint *shape, mx_uint ndim,
                            const float *data, size_t n) {
  NDArrayHandle h;
  CHECK(MXTNDArrayCreate(shape, ndim, g_dev_type, g_dev_id, 0, &h));
  if (data) CHECK(MXTNDArraySyncCopyFromCPU(h, data, n));
  return h;
}

static void sgd_updater(int key, NDArrayHandle recv, NDArrayHandle local,
                        void *handle) {
  /* local -= 0.1 * recv, via the ABI re-entrantly */
  mx_uint ndim;
  const mx_uint *shape;
  CHECK(MXTNDArrayGetShape(local, &ndim, &shape));
  size_t n = 1;
  for (mx_uint i = 0; i < ndim; ++i) n *= shape[i];
  float *w = malloc(n * sizeof(float)), *g = malloc(n * sizeof(float));
  CHECK(MXTNDArraySyncCopyToCPU(local, w, n));
  CHECK(MXTNDArraySyncCopyToCPU(recv, g, n));
  for (size_t i = 0; i < n; ++i) w[i] -= 0.1f * g[i];
  CHECK(MXTNDArraySyncCopyFromCPU(local, w, n));
  free(w);
  free(g);
  (void)key;
  (void)handle;
}

int main(int argc, char **argv) {
  if (argc > 1) g_dev_type = atoi(argv[1]);
  if (argc > 2) g_dev_id = atoi(argv[2]);
  const int batch = 4, in_dim = 6, classes = 3;

  /* symbol: data -> FC(8) -> relu -> FC(3) -> SoftmaxOutput */
  SymbolHandle data;
  CHECK(MXTSymbolCreateVariable("data", &data));
  const char *k1[] = {"num_hidden"};
  const char *v1[] = {"8"};
  const char *ik[] = {"data"};
  SymbolHandle iv1[] = {data};
  SymbolHandle fc1 = atomic("FullyConnected", "fc1", 1, k1, v1, 1, ik, iv1);
  const char *ka[] = {"act_type"};
  const char *va[] = {"relu"};
  SymbolHandle iva[] = {fc1};
  SymbolHandle act = atomic("Activation", "relu1", 1, ka, va, 1, ik, iva);
  const char *v2[] = {"3"};
  SymbolHandle iv2[] = {act};
  SymbolHandle fc2 = atomic("FullyConnected", "fc2", 1, k1, v2, 1, ik, iv2);
  SymbolHandle iv3[] = {fc2};
  SymbolHandle net = atomic("SoftmaxOutput", "softmax", 0, NULL, NULL, 1,
                            ik, iv3);

  /* infer shapes from data=(4,6) */
  const char *keys[] = {"data"};
  mx_uint indptr[] = {0, 2};
  mx_uint sdata[] = {(mx_uint)batch, (mx_uint)in_dim};
  mx_uint iss, oss, ass;
  const mx_uint *isn, *osn, *asn;
  const mx_uint **isd, **osd, **asd;
  int complete;
  CHECK(MXTSymbolInferShape(net, 1, keys, indptr, sdata, &iss, &isn, &isd,
                            &oss, &osn, &osd, &ass, &asn, &asd, &complete));
  if (!complete) {
    fprintf(stderr, "shape inference incomplete\n");
    return 1;
  }

  /* allocate args + grads, fill with a fixed pattern */
  mx_uint nargs = iss;
  NDArrayHandle *args = malloc(nargs * sizeof(NDArrayHandle));
  NDArrayHandle *grads = malloc(nargs * sizeof(NDArrayHandle));
  mx_uint *reqs = malloc(nargs * sizeof(mx_uint));
  for (mx_uint i = 0; i < nargs; ++i) {
    size_t n = 1;
    for (mx_uint j = 0; j < isn[i]; ++j) n *= isd[i][j];
    float *buf = malloc(n * sizeof(float));
    for (size_t j = 0; j < n; ++j)
      buf[j] = 0.05f * (float)((j * 2654435761u + i * 97) % 19) - 0.45f;
    args[i] = nd_new(isd[i], isn[i], buf, n);
    free(buf);
    grads[i] = nd_new(isd[i], isn[i], NULL, 0);
    reqs[i] = 1; /* write */
  }
  /* labels: 0..batch-1 mod classes */
  {
    float lab[4];
    for (int i = 0; i < batch; ++i) lab[i] = (float)(i % classes);
    CHECK(MXTNDArraySyncCopyFromCPU(args[nargs - 1], lab, batch));
  }

  ExecutorHandle exe;
  CHECK(MXTExecutorBind(net, g_dev_type, g_dev_id, nargs, args, grads, reqs, 0, NULL,
                        &exe));
  CHECK(MXTExecutorForward(exe, 1));
  mx_uint nout;
  NDArrayHandle *outs;
  CHECK(MXTExecutorOutputs(exe, &nout, &outs));
  float probs[12];
  CHECK(MXTNDArraySyncCopyToCPU(outs[0], probs, batch * classes));
  for (int i = 0; i < batch; ++i) {
    float s = 0;
    for (int c = 0; c < classes; ++c) s += probs[i * classes + c];
    if (s < 0.99f || s > 1.01f) {
      fprintf(stderr, "row %d does not sum to 1 (%f)\n", i, s);
      return 1;
    }
  }
  CHECK(MXTExecutorBackward(exe, 0, NULL));

  /* push fc1_weight's gradient through a local kvstore w/ C updater */
  KVStoreHandle kv;
  CHECK(MXTKVStoreCreate("local", &kv));
  int kkeys[] = {0};
  NDArrayHandle w[] = {args[1]};
  NDArrayHandle g[] = {grads[1]};
  CHECK(MXTKVStoreInit(kv, 1, kkeys, w));
  CHECK(MXTKVStoreSetUpdater(kv, sgd_updater, NULL));
  CHECK(MXTKVStorePush(kv, 1, kkeys, g, 0));
  CHECK(MXTKVStorePull(kv, 1, kkeys, w, 0));

  printf("capi_example OK: forward sums to 1, backward ran, "
         "kvstore update applied\n");
  return 0;
}
