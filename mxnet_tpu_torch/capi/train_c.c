/*
 * Complete C training program over the graph ABI — the proof that the
 * ABI can carry a language binding (reference: scala-package/ and
 * R-package/ sit on exactly this surface, include/mxnet/c_api.h).
 *
 * End-to-end through C only:
 *   1. writes a synthetic separable dataset to CSV (MNIST stand-in:
 *      this image has no egress, the same convention tests/test_train.py
 *      uses),
 *   2. creates a CSVIter through the DataIter ABI,
 *   3. composes an MLP Symbol, infers shapes, binds an Executor,
 *   4. trains with forward/backward + KVStore push/pull and a C
 *      momentum-SGD updater callback,
 *   5. scores and requires accuracy > 0.9.
 *
 * Built by mxnet_tpu_torch.capi.build_example("train_c"); run as
 * train_c [dev_type [dev_id]].
 */
#include <math.h>
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

#define N_SAMPLES 2000
#define IN_DIM 20
#define CLASSES 5
#define BATCH 100
#define HIDDEN 64
#define EPOCHS 8

/* xorshift PRNG so the dataset is deterministic across runs */
static unsigned rng_state = 12345u;
static float frand(void) {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 17;
  rng_state ^= rng_state << 5;
  return (float)(rng_state & 0xffffff) / (float)0x1000000;
}
static float nrand(void) { /* rough normal via CLT */
  float s = 0;
  for (int i = 0; i < 12; ++i) s += frand();
  return s - 6.0f;
}

static SymbolHandle atomic_sym(const char *op, const char *name,
                               unsigned nparam, const char **pk,
                               const char **pv, unsigned nin,
                               const char **ik, SymbolHandle *iv) {
  SymbolHandle h;
  CHECK(MXTSymbolCreateAtomicSymbol((AtomicSymbolCreator)op, nparam, pk,
                                    pv, &h));
  CHECK(MXTSymbolCompose(h, name, nin, ik, iv));
  return h;
}

/* momentum-SGD state the updater closes over (per key) */
typedef struct {
  float *mom[16];
  size_t size[16];
} UpdaterState;

static void sgd_momentum_updater(int key, NDArrayHandle recv,
                                 NDArrayHandle local, void *handle) {
  UpdaterState *st = (UpdaterState *)handle;
  const float lr = 0.1f, momentum = 0.9f, wd = 1e-4f,
              rescale = 1.0f / BATCH;
  mx_uint ndim;
  const mx_uint *shape;
  CHECK(MXTNDArrayGetShape(local, &ndim, &shape));
  size_t n = 1;
  for (mx_uint i = 0; i < ndim; ++i) n *= shape[i];
  if (st->mom[key] == NULL) {
    st->mom[key] = calloc(n, sizeof(float));
    st->size[key] = n;
  }
  float *w = malloc(n * sizeof(float)), *g = malloc(n * sizeof(float));
  CHECK(MXTNDArraySyncCopyToCPU(local, w, n));
  CHECK(MXTNDArraySyncCopyToCPU(recv, g, n));
  float *m = st->mom[key];
  for (size_t i = 0; i < n; ++i) {
    float grad = g[i] * rescale + wd * w[i];
    m[i] = momentum * m[i] - lr * grad;
    w[i] += m[i];
  }
  CHECK(MXTNDArraySyncCopyFromCPU(local, w, n));
  free(w);
  free(g);
}

static void write_dataset(const char *data_path, const char *label_path,
                          float *labels_out) {
  /* y = argmax(X @ W_true): linearly separable, like tests/test_train */
  static float wtrue[IN_DIM][CLASSES];
  for (int i = 0; i < IN_DIM; ++i)
    for (int c = 0; c < CLASSES; ++c) wtrue[i][c] = nrand();
  FILE *fd = fopen(data_path, "w");
  FILE *fl = fopen(label_path, "w");
  if (!fd || !fl) {
    fprintf(stderr, "cannot write dataset files\n");
    exit(1);
  }
  for (int r = 0; r < N_SAMPLES; ++r) {
    float x[IN_DIM], score[CLASSES] = {0};
    for (int i = 0; i < IN_DIM; ++i) {
      x[i] = nrand();
      fprintf(fd, i ? ",%.6f" : "%.6f", x[i]);
    }
    fprintf(fd, "\n");
    for (int c = 0; c < CLASSES; ++c)
      for (int i = 0; i < IN_DIM; ++i) score[c] += x[i] * wtrue[i][c];
    int best = 0;
    for (int c = 1; c < CLASSES; ++c)
      if (score[c] > score[best]) best = c;
    fprintf(fl, "%d\n", best);
    labels_out[r] = (float)best;
  }
  fclose(fd);
  fclose(fl);
}

int main(int argc, char **argv) {
  if (argc > 1) g_dev_type = atoi(argv[1]);
  if (argc > 2) g_dev_id = atoi(argv[2]);
  char data_csv[256], label_csv[256];
  const char *tmp = getenv("TMPDIR");
  if (!tmp) tmp = "/tmp";
  snprintf(data_csv, sizeof data_csv, "%s/train_c_data.csv", tmp);
  snprintf(label_csv, sizeof label_csv, "%s/train_c_label.csv", tmp);
  float *all_labels = malloc(N_SAMPLES * sizeof(float));
  write_dataset(data_csv, label_csv, all_labels);

  /* ---- DataIter: CSVIter through the registry ---------------------- */
  mx_uint n_iters;
  DataIterCreator *iters;
  CHECK(MXTListDataIters(&n_iters, &iters));
  DataIterCreator csv_creator = NULL;
  for (mx_uint i = 0; i < n_iters; ++i) {
    const char *name, *desc;
    mx_uint na;
    const char **an, **at, **ad;
    CHECK(MXTDataIterGetIterInfo(iters[i], &name, &desc, &na, &an, &at,
                                 &ad));
    if (strcmp(name, "CSVIter") == 0) csv_creator = iters[i];
  }
  if (!csv_creator) {
    fprintf(stderr, "CSVIter not registered\n");
    return 1;
  }
  char bs[16], dshape[32];
  snprintf(bs, sizeof bs, "%d", BATCH);
  snprintf(dshape, sizeof dshape, "(%d,)", IN_DIM);
  const char *ikeys[] = {"data_csv", "data_shape", "label_csv",
                         "batch_size", "round_batch"};
  const char *ivals[] = {data_csv, dshape, label_csv, bs, "True"};
  DataIterHandle it;
  CHECK(MXTDataIterCreateIter(csv_creator, 5, ikeys, ivals, &it));

  /* ---- Symbol: MLP -------------------------------------------------- */
  SymbolHandle dvar;
  CHECK(MXTSymbolCreateVariable("data", &dvar));
  const char *ik[] = {"data"};
  const char *hk[] = {"num_hidden"};
  char hidden_s[8], classes_s[8];
  snprintf(hidden_s, sizeof hidden_s, "%d", HIDDEN);
  snprintf(classes_s, sizeof classes_s, "%d", CLASSES);
  const char *hv1[] = {hidden_s};
  SymbolHandle iv1[] = {dvar};
  SymbolHandle fc1 = atomic_sym("FullyConnected", "fc1", 1, hk, hv1, 1,
                                ik, iv1);
  const char *ak[] = {"act_type"};
  const char *av[] = {"relu"};
  SymbolHandle iva[] = {fc1};
  SymbolHandle act = atomic_sym("Activation", "relu1", 1, ak, av, 1, ik,
                                iva);
  const char *hv2[] = {classes_s};
  SymbolHandle iv2[] = {act};
  SymbolHandle fc2 = atomic_sym("FullyConnected", "fc2", 1, hk, hv2, 1,
                                ik, iv2);
  SymbolHandle iv3[] = {fc2};
  SymbolHandle net = atomic_sym("SoftmaxOutput", "softmax", 0, NULL, NULL,
                                1, ik, iv3);

  /* ---- shapes + executor ------------------------------------------- */
  const char *skeys[] = {"data"};
  mx_uint indptr[] = {0, 2};
  mx_uint sdata[] = {BATCH, IN_DIM};
  mx_uint iss, oss, ass;
  const mx_uint *isn, *osn, *asn;
  const mx_uint **isd, **osd, **asd;
  int complete;
  CHECK(MXTSymbolInferShape(net, 1, skeys, indptr, sdata, &iss, &isn,
                            &isd, &oss, &osn, &osd, &ass, &asn, &asd,
                            &complete));
  if (!complete) {
    fprintf(stderr, "shape inference incomplete\n");
    return 1;
  }
  mx_uint n_names;
  const char **arg_names;
  CHECK(MXTSymbolListArguments(net, &n_names, &arg_names));
  if (n_names != iss || n_names > 16) {
    fprintf(stderr, "unexpected arg count %u\n", n_names);
    return 1;
  }

  NDArrayHandle args[16], grads[16];
  mx_uint reqs[16];
  int data_idx = -1, label_idx = -1;
  for (mx_uint i = 0; i < n_names; ++i) {
    size_t n = 1;
    for (mx_uint j = 0; j < isn[i]; ++j) n *= isd[i][j];
    CHECK(MXTNDArrayCreate(isd[i], isn[i], g_dev_type, g_dev_id, 0, &args[i]));
    CHECK(MXTNDArrayCreate(isd[i], isn[i], g_dev_type, g_dev_id, 0, &grads[i]));
    float *buf = calloc(n, sizeof(float));
    if (strcmp(arg_names[i], "data") == 0) data_idx = (int)i;
    else if (strstr(arg_names[i], "label")) label_idx = (int)i;
    else /* Xavier-ish init */
      for (size_t j = 0; j < n; ++j) buf[j] = (frand() - 0.5f) * 0.2f;
    CHECK(MXTNDArraySyncCopyFromCPU(args[i], buf, n));
    CHECK(MXTNDArraySyncCopyFromCPU(grads[i], buf, 0 * n + n)); /* zeros */
    free(buf);
    reqs[i] = 1; /* write */
  }
  if (data_idx < 0 || label_idx < 0) {
    fprintf(stderr, "data/label args not found\n");
    return 1;
  }
  ExecutorHandle exe;
  CHECK(MXTExecutorBind(net, g_dev_type, g_dev_id, n_names, args, grads, reqs, 0, NULL,
                        &exe));

  /* ---- KVStore with C updater -------------------------------------- */
  KVStoreHandle kv;
  CHECK(MXTKVStoreCreate("local", &kv));
  UpdaterState ust;
  memset(&ust, 0, sizeof ust);
  CHECK(MXTKVStoreSetUpdater(kv, sgd_momentum_updater, &ust));
  int kv_keys[16];
  int n_params = 0;
  int param_idx[16];
  for (mx_uint i = 0; i < n_names; ++i) {
    if ((int)i == data_idx || (int)i == label_idx) continue;
    kv_keys[n_params] = n_params;
    param_idx[n_params] = (int)i;
    CHECK(MXTKVStoreInit(kv, 1, &kv_keys[n_params], &args[i]));
    ++n_params;
  }

  /* ---- training loop ------------------------------------------------ */
  float *dbuf = malloc(BATCH * IN_DIM * sizeof(float));
  float *lbuf = malloc(BATCH * sizeof(float));
  float *probs = malloc(BATCH * CLASSES * sizeof(float));
  float acc = 0;
  for (int epoch = 0; epoch < EPOCHS; ++epoch) {
    CHECK(MXTDataIterBeforeFirst(it));
    int more = 0, correct = 0, seen = 0;
    for (;;) {
      CHECK(MXTDataIterNext(it, &more));
      if (!more) break;
      NDArrayHandle bd, bl;
      CHECK(MXTDataIterGetData(it, &bd));
      CHECK(MXTDataIterGetLabel(it, &bl));
      CHECK(MXTNDArraySyncCopyToCPU(bd, dbuf, BATCH * IN_DIM));
      CHECK(MXTNDArraySyncCopyToCPU(bl, lbuf, BATCH));
      CHECK(MXTNDArraySyncCopyFromCPU(args[data_idx], dbuf,
                                      BATCH * IN_DIM));
      CHECK(MXTNDArraySyncCopyFromCPU(args[label_idx], lbuf, BATCH));
      CHECK(MXTExecutorForward(exe, 1));
      CHECK(MXTExecutorBackward(exe, 0, NULL));
      /* push grads / pull updated weights (update-on-kvstore path) */
      for (int p = 0; p < n_params; ++p) {
        CHECK(MXTKVStorePush(kv, 1, &kv_keys[p], &grads[param_idx[p]],
                             0));
        CHECK(MXTKVStorePull(kv, 1, &kv_keys[p], &args[param_idx[p]],
                             0));
      }
      /* training accuracy from the executor outputs */
      mx_uint nout;
      NDArrayHandle *outs;
      CHECK(MXTExecutorOutputs(exe, &nout, &outs));
      CHECK(MXTNDArraySyncCopyToCPU(outs[0], probs, BATCH * CLASSES));
      for (int r = 0; r < BATCH; ++r) {
        int best = 0;
        for (int c = 1; c < CLASSES; ++c)
          if (probs[r * CLASSES + c] > probs[r * CLASSES + best]) best = c;
        if (best == (int)lbuf[r]) ++correct;
        ++seen;
      }
    }
    acc = (float)correct / (float)seen;
    printf("epoch %d train-accuracy %.4f\n", epoch, acc);
  }

  if (acc <= 0.9f) {
    fprintf(stderr, "FAIL: final accuracy %.4f <= 0.9\n", acc);
    return 1;
  }
  printf("C-ABI training OK: accuracy %.4f\n", acc);
  CHECK(MXTExecutorFree(exe));
  CHECK(MXTDataIterFree(it));
  CHECK(MXTKVStoreFree(kv));
  CHECK(MXTNotifyShutdown());
  return 0;
}
