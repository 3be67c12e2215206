"""The book's other models (counterpart of
paddle_tpu/models/book_extra.py; reference: python/paddle/fluid/tests/
book/ — test_fit_a_line.py, test_image_classification.py's VGG branch,
notest_understand_sentiment.py, test_recommender_system.py,
test_label_semantic_roles.py). Each build function returns (main, startup,
feed_names, loss[, extras]) like the other model modules; the callers
make the data (the TPU package's synthetic stand-ins live in
paddle_tpu/dataset, which the port does not import)."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers

__all__ = ["build_fit_a_line", "vgg16", "build_vgg_cifar",
           "convolution_net", "build_sentiment_program",
           "build_recommender_program", "build_srl_crf_program"]


# --------------------------------------------------------------------------
# fit_a_line — the book's first program (linear regression on uci_housing)
# --------------------------------------------------------------------------
def build_fit_a_line(lr=0.01):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[13], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="float32")
        pred = layers.fc(x, 1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, ["x", "y"], loss


# --------------------------------------------------------------------------
# VGG — the book's image_classification vgg branch (img_conv_group stacks)
# --------------------------------------------------------------------------
def vgg16(input, class_dim=10):
    from ..fluid import nets

    def group(inp, num, filters):
        return nets.img_conv_group(
            inp, conv_num_filter=[filters] * num, pool_size=2,
            pool_stride=2, conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=0.0)

    x = group(input, 2, 64)
    x = group(x, 2, 128)
    x = group(x, 3, 256)
    x = group(x, 3, 512)
    x = group(x, 3, 512)
    x = layers.fc(x, 512, act=None)
    x = layers.batch_norm(x, act="relu")
    x = layers.fc(x, 512, act=None)
    return layers.fc(x, class_dim, act="softmax")


def build_vgg_cifar(class_dim=10, image_size=32, lr=1e-3, depth="small"):
    """depth="small": a 2-group VGG for test-speed; "16": full VGG16."""
    from ..fluid import nets
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", shape=[3, image_size, image_size],
                         dtype="float32")
        label = fluid.data("label", shape=[1], dtype="int64")
        if depth == "16":
            pred = vgg16(img, class_dim)
        else:
            x = nets.img_conv_group(img, conv_num_filter=[32, 32],
                                    pool_size=2, pool_stride=2,
                                    conv_act="relu",
                                    conv_with_batchnorm=True)
            x = nets.img_conv_group(x, conv_num_filter=[64, 64],
                                    pool_size=2, pool_stride=2,
                                    conv_act="relu",
                                    conv_with_batchnorm=True)
            x = layers.fc(x, 128, act="relu")
            pred = layers.fc(x, class_dim, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        acc = layers.accuracy(pred, label)
        fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, ["img", "label"], loss, acc


# --------------------------------------------------------------------------
# understand_sentiment — text conv net over LoD word ids
# --------------------------------------------------------------------------
def convolution_net(data, dict_dim, class_dim=2, emb_dim=32, hid_dim=32):
    """The book's conv_net: embedding + two sequence_conv_pool branches
    (notest_understand_sentiment.py convolution_net)."""
    from ..fluid import nets
    emb = layers.embedding(data, size=[dict_dim, emb_dim], is_sparse=True)
    conv3 = nets.sequence_conv_pool(emb, num_filters=hid_dim, filter_size=3,
                                    act="tanh", pool_type="sqrt")
    conv4 = nets.sequence_conv_pool(emb, num_filters=hid_dim, filter_size=4,
                                    act="tanh", pool_type="sqrt")
    return layers.fc([conv3, conv4], class_dim, act="softmax")


def build_sentiment_program(dict_dim, class_dim=2, lr=1e-3):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.data("words", shape=[1], dtype="int64", lod_level=1)
        label = fluid.data("label", shape=[1], dtype="int64")
        pred = convolution_net(words, dict_dim, class_dim)
        loss = layers.mean(layers.cross_entropy(pred, label))
        acc = layers.accuracy(pred, label)
        fluid.optimizer.Adagrad(lr).minimize(loss)
    return main, startup, ["words", "label"], loss, acc


# --------------------------------------------------------------------------
# recommender_system — the book's user/movie embedding model
# --------------------------------------------------------------------------
def build_recommender_program(n_users, n_movies, n_jobs=21, n_ages=7,
                              n_cates=18, title_vocab=1000, emb=16, lr=5e-3):
    """User tower (id+gender+age+job embeddings → fc) and movie tower
    (id emb + category/title pooled embs → fc), cosine-scaled score vs the
    5-star rating (test_recommender_system.py model)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        uid = fluid.data("user_id", shape=[1], dtype="int64")
        gender = fluid.data("gender_id", shape=[1], dtype="int64")
        age = fluid.data("age_id", shape=[1], dtype="int64")
        job = fluid.data("job_id", shape=[1], dtype="int64")
        mid = fluid.data("movie_id", shape=[1], dtype="int64")
        cats = fluid.data("category_id", shape=[1], dtype="int64",
                          lod_level=1)
        title = fluid.data("movie_title", shape=[1], dtype="int64",
                           lod_level=1)
        score = fluid.data("score", shape=[1], dtype="float32")

        def emb_fc(ids, size):
            e = layers.embedding(ids, size=[size, emb], is_sparse=True)
            return layers.reshape(e, [-1, emb])

        usr = layers.concat(
            [emb_fc(uid, n_users + 1), emb_fc(gender, 2),
             emb_fc(age, n_ages), emb_fc(job, n_jobs)], axis=1)
        usr = layers.fc(usr, 32, act="relu")

        mov_id = emb_fc(mid, n_movies + 1)
        cat_e = layers.embedding(cats, size=[n_cates, emb], is_sparse=True)
        cat_p = layers.sequence_pool(cat_e, pool_type="sum")
        ttl_e = layers.embedding(title, size=[title_vocab, emb],
                                 is_sparse=True)
        ttl_p = layers.sequence_pool(ttl_e, pool_type="sum")
        mov = layers.concat([mov_id, cat_p, ttl_p], axis=1)
        mov = layers.fc(mov, 32, act="relu")

        sim = layers.cos_sim(usr, mov)
        pred = layers.scale(sim, scale=5.0)
        loss = layers.mean(layers.square_error_cost(pred, score))
        fluid.optimizer.Adam(lr).minimize(loss)
    feeds = ["user_id", "gender_id", "age_id", "job_id", "movie_id",
             "category_id", "movie_title", "score"]
    return main, startup, feeds, loss


# --------------------------------------------------------------------------
# label_semantic_roles — sequence tagging with a linear-chain CRF
# --------------------------------------------------------------------------
def build_srl_crf_program(word_dict_len, label_dict_len, emb=32, hidden=64,
                          lr=1e-2):
    """Simplified SRL tagger (test_label_semantic_roles.py shape): word
    embeddings → fc stack → linear_chain_crf loss + crf_decoding."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        word = fluid.data("word", shape=[1], dtype="int64", lod_level=1)
        target = fluid.data("target", shape=[1], dtype="int64", lod_level=1)
        e = layers.embedding(word, size=[word_dict_len, emb])
        e = layers.reshape(e, [-1, emb])
        h = layers.fc(e, hidden, act="tanh")
        feature = layers.fc(h, label_dict_len, act=None)
        crf_cost = layers.linear_chain_crf(
            input=feature, label=target,
            param_attr=fluid.ParamAttr(name="crfw"))
        loss = layers.mean(crf_cost)
        decode = layers.crf_decoding(
            input=feature, param_attr=fluid.ParamAttr(name="crfw"))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, ["word", "target"], loss, decode
